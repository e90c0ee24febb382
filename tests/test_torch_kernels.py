"""Kernels B1, B2, B2t, B3 and B4 on the card against their plain
PyTorch versions.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels.py

B1 and B4 must equal their plain versions bit for bit; B1 also as a
step's group of leaves in one launch, on views off the 16-byte grid, and
over more leaves than one launch's table. B2 is held to the f32
summation bound K * 2^-24 * (|x| @ |w_eff|): both compute w_eff with
the same IEEE operations and differ only in the order of the K-sum; its
storage layouts, its fused scale and a repeated call must give the same
bits.
B2t and B3 (the tiled reads, per-tile ADC) must equal their plain
versions bit for bit, on dyadic and on random inputs: on the card the
plain read sums each tile's partial in the kernels' k order
(`ordered_tile_partials`). B2t's storage layouts, a repeated call, its tile heights and
one lane read alone or as lane 0 of four must give the same bits. B3
must give the bits of B2t over the patch rows at the same tiles, twice.
Both hold where a lane has more tile steps than the ADC pass keeps in
shared memory, and over more lanes than a grid's rows."""
import numpy as np
import pytest
import torch

from rram_caffe_simulation_tpu_torch.fault import fused as tfused
from rram_caffe_simulation_tpu_torch.fault import hw_aware as thw
from rram_caffe_simulation_tpu_torch.fault import packed as tpacked
from rram_caffe_simulation_tpu_torch.ops import pool_backward as tpool

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    from rram_caffe_simulation_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def b1_leaf(shape, seed, dtype):
    rng = np.random.RandomState(seed)
    data = rng.randn(*shape).astype(np.float32)
    upd = (rng.randn(*shape) * 1e-3).astype(np.float32)
    sel = rng.rand(*shape)
    upd[sel < 0.2] = 0.0
    upd[(sel >= 0.2) & (sel < 0.25)] = 1e-20
    upd[(sel >= 0.25) & (sel < 0.3)] = -9.99e-21
    lq = rng.randint(-3, 4, size=shape).astype(dtype)
    bank = tpacked.pack_stuck(rng.choice([-1.0, 0.0, 1.0], size=shape))
    return data, upd, lq, bank


@pytest.mark.parametrize("mode", tfused.FUSED_MODES)
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("shape", [(64, 1024), (64,), (10, 64), (10,),
                                   (4, 10, 64), (3, 7), (5, 13)])
def test_b1_kernel_equals_plain(cuda_device, shape, dtype, mode):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in b1_leaf(shape, 5, dtype)]
    kd, kl = tfused.fused_update_fail(*args, mode=mode)
    pd, pl = tfused.fused_update_fail_plain(*args, mode=mode)
    assert torch.equal(kd.view(torch.int32), pd.view(torch.int32))
    assert torch.equal(kl, pl)


UNTILED_LEAVES = [(64, 1024), (64,), (10, 64), (10,)]
TILED_LEAVES = [(32, 3, 5, 5), (32,), (32, 32, 5, 5), (32,), (64, 32, 5, 5),
                (64,)] + UNTILED_LEAVES


def b1_group(device, shapes, C, dtype, seed):
    lead = (C,) if C > 1 else ()
    leaves = [[torch.from_numpy(a).to(device)
               for a in b1_leaf(lead + s, seed + i, dtype)]
              for i, s in enumerate(shapes)]
    return [[lf[j] for lf in leaves] for j in range(4)]


def assert_group_equals_plain(groups, mode):
    kd, kl = tfused.fused_update_fail_leaves(*groups, mode=mode)
    pd, pl = tfused.fused_update_fail_leaves_plain(*groups, mode=mode)
    for a, b, c, d in zip(kd, pd, kl, pl):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(c, d)


@pytest.mark.parametrize("mode", tfused.FUSED_MODES)
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("shapes", [UNTILED_LEAVES, TILED_LEAVES],
                         ids=["untiled", "tiled"])
def test_b1_group_equals_plain_in_one_launch(cuda_device, shapes, C, dtype,
                                            mode):
    groups = b1_group(cuda_device, shapes, C, dtype, 11)
    tfused.FUSED_LIB.reset()
    assert_group_equals_plain(groups, mode)
    assert tfused.FUSED_LIB.launches == 1


def _off_grid(t, offset):
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_b1_group_with_leaves_off_the_16_byte_grid(cuda_device, dtype):
    """Views off the 16-byte grid take the scalar route in the same
    launch: all of leaf 0's operands, upd of leaf 2, the counters of
    ip1's weight."""
    d, u, q, b = b1_group(cuda_device, TILED_LEAVES, 3, dtype, 21)
    d[0], u[0], q[0], b[0] = (_off_grid(t, 1) for t in (d[0], u[0], q[0],
                                                         b[0]))
    u[2], q[6] = _off_grid(u[2], 3), _off_grid(q[6], 2)
    for mode in tfused.FUSED_MODES:
        assert_group_equals_plain([d, u, q, b], mode)


def test_b1_group_larger_than_a_table(cuda_device):
    groups = b1_group(cuda_device, TILED_LEAVES * 2, 2, np.int32, 31)
    tfused.FUSED_LIB.reset()
    assert_group_equals_plain(groups, "write")
    assert tfused.FUSED_LIB.launches == 2


def within_sum_bound(y, y_ref, x, w_eff, slack=1.0):
    K = w_eff.shape[-2]
    bound = slack * K * 2.0 ** -24 * torch.matmul(x.abs(), w_eff.abs())
    return bool(((y - y_ref).abs() <= bound + 1e-30).all())


@pytest.mark.parametrize("q_bits", [0, 2, 8])
@pytest.mark.parametrize("C,M,K,N", [(1, 100, 1024, 64), (1, 100, 64, 10),
                                     (4, 33, 70, 19)])
def test_b2_kernel_matches_plain(cuda_device, q_bits, C, M, K, N):
    rng = np.random.RandomState(q_bits + C)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
    x = t(rng.randn(M, K).astype(np.float32))
    xs = t(rng.randn(C, M, K).astype(np.float32))
    w = t((rng.randn(C, K, N) * 0.3).astype(np.float32))
    broken = t((rng.rand(C, K, N) < 0.15).astype(np.float32))
    stuck = t(rng.choice([-1.0, 0.0, 1.0], size=(C, K, N)).astype(np.float32))
    seeds = t(np.arange(7, 7 + C, dtype=np.int32))
    eps = t(rng.randn(C, K, N).astype(np.float32))
    levels = thw.q_levels(q_bits)
    for xin in (x, xs):
        for sigma, e in ((0.0, None), (0.05, eps), (0.05, None)):
            y = thw.crossbar_forward(xin, w, broken, stuck, seeds, sigma,
                                     q_bits, eps=e)
            yp = thw.crossbar_forward_plain(xin, w, broken, stuck, seeds,
                                            sigma, q_bits, eps=e)
            noise = e if e is not None else thw.philox_normal(seeds, K, N,
                                                              cuda_device)
            w_eff = thw.effective_weight_plain(
                w, broken, stuck, sigma, noise, levels,
                w.abs().amax(dim=(1, 2)))
            # in-kernel noise: libm's log/cos may differ by an ulp
            slack = 4.0 if (sigma and e is None) else 1.0
            assert within_sum_bound(y, yp, xin, w_eff, slack)


B2_RAGGED = [(1, 7, 3), (5, 18, 7), (100, 1000, 10), (130, 257, 65),
             (100, 1024, 64), (100, 64, 10)]


def b2_case(device, C, M, K, N, x_batched, seed):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    x = t(rng.randn(*((C, M, K) if x_batched else (M, K)))
          .astype(np.float32))
    w = t((rng.randn(C, K, N) * 0.3).astype(np.float32))
    broken = t(rng.rand(C, K, N) < 0.15)
    stuck = t(rng.choice([-1.0, 0.0, 1.0], size=(C, K, N)).astype(np.float32))
    eps = t(rng.randn(C, K, N).astype(np.float32))
    seeds = t(np.arange(7, 7 + C, dtype=np.int32))
    return x, w, broken, stuck, eps, seeds


def b2_layouts(x, w, broken, stuck, eps):
    """The operands in every storage layout the wrapper takes (see
    chip_smoke.b2_layouts): stored (C, N, K) turned by view with x as the
    (M, C, K) view, rows off the 16-byte grid, a mix with uint8 broken,
    and broken as f32 0/1."""
    turned = lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)
    folded = lambda t: (t.transpose(0, 1).contiguous().transpose(0, 1)
                        if t.dim() == 3 else t)

    def padded(t):
        big = torch.zeros(t.shape[:-1] + (t.shape[-1] + 3,), dtype=t.dtype,
                          device=t.device)
        big[..., 1:-2] = t
        return big[..., 1:-2]

    return {"stored": (folded(x), turned(w), turned(broken), turned(stuck),
                       turned(eps)),
            "unaligned": tuple(padded(t) for t in (x, w, broken, stuck, eps)),
            "mixed": (x, turned(w), broken.to(torch.uint8), stuck,
                      turned(eps)),
            "broken_f32": (x, w, broken.float(), stuck, eps)}


@pytest.mark.parametrize("M,K,N", B2_RAGGED)
@pytest.mark.parametrize("C,x_batched", [(1, False), (4, False), (4, True)])
def test_b2_ragged_shapes_layouts_and_repeat(cuda_device, M, K, N, C,
                                             x_batched):
    """Ragged shapes within the summation bound of the plain version;
    every layout equal to the dense call bit for bit; the scale reduced
    inside the call equal to w.abs().amax; a second call equal to the
    first (split-K sums in a fixed order)."""
    x, w, br, st, eps, seeds = b2_case(cuda_device, C, M, K, N, x_batched,
                                       M + K)
    amax = w.abs().amax(dim=(1, 2))
    for q_bits in (0, 2):
        for sigma, e in ((0.0, None), (0.05, eps)):
            y, scale = thw.crossbar_forward_scaled(x, w, br, st, seeds,
                                                   sigma, q_bits, eps=e)
            yp = thw.crossbar_forward_plain(x, w, br, st, seeds, sigma,
                                            q_bits, eps=e)
            w_eff = thw.effective_weight_plain(
                w, br, st, sigma, e, thw.q_levels(q_bits), amax)
            assert within_sum_bound(y, yp, x, w_eff)
            assert (scale is None) if not q_bits else torch.equal(scale, amax)
            again = thw.crossbar_forward(x, w, br, st, seeds, sigma, q_bits,
                                         eps=e)
            assert torch.equal(again, y)
            for name, (lx, lw, lb, ls, le) in b2_layouts(x, w, br, st,
                                                         eps).items():
                yl, sl = thw.crossbar_forward_scaled(
                    lx, lw, lb, ls, seeds, sigma, q_bits,
                    eps=le if e is not None else None)
                assert torch.equal(yl, y), name
                assert (sl is None) if not q_bits else torch.equal(sl, amax)


@pytest.mark.parametrize("M,K,N", [(100, 1024, 64), (100, 64, 10),
                                   (33, 70, 19)])
def test_b2_shared_x_equals_per_lane_x(cuda_device, M, K, N):
    """One x shared by the lanes (lane stride 0) against the same x
    copied to every lane: the same kernel variant, the same bits."""
    C = 4
    x, w, br, st, _, seeds = b2_case(cuda_device, C, M, K, N, False, 3)
    shared = thw.crossbar_forward(x, w, br, st, seeds, 0.05, 2)
    per_lane = thw.crossbar_forward(x.expand(C, M, K).contiguous(), w, br,
                                    st, seeds, 0.05, 2)
    assert torch.equal(shared, per_lane)
    # and an expanded view (lane stride 0 in a 3-D x) is read in place
    assert torch.equal(thw.crossbar_forward(x.expand(C, M, K), w, br, st,
                                            seeds, 0.05, 2), shared)


@pytest.mark.parametrize("M,K,N", [(100, 1024, 64), (100, 64, 10),
                                   (33, 70, 19)])
def test_b2_one_lane_against_lane_0_of_four(cuda_device, M, K, N):
    """Where C = 1 splits K over more blocks than C = 4 does (ip1), the
    two sum in other orders and stay within the summation bound of each
    other; where the plan is the same they give the same bits. Their
    w_eff and noise are the same either way."""
    x, w, br, st, _, seeds = b2_case(cuda_device, 4, M, K, N, False, 5)
    four = thw.crossbar_forward(x, w, br, st, seeds, 0.05, 2)
    one = thw.crossbar_forward(x, w[:1], br[:1], st[:1], seeds[:1], 0.05, 2)
    if thw.b2_plan(1, M, K, N) == thw.b2_plan(4, M, K, N):
        assert torch.equal(one, four[:1])
    noise = thw.philox_normal(seeds[:1], K, N, cuda_device)
    w_eff = thw.effective_weight_plain(w[:1], br[:1], st[:1], 0.05, noise,
                                       1.0, w[:1].abs().amax(dim=(1, 2)))
    # twice the bound (each side is one summation away from exact), and
    # the in-kernel noise against its tensor-op twin: libm's last ulp
    assert within_sum_bound(one, four[:1], x, w_eff, slack=8.0)


@pytest.mark.parametrize("M,K,N", [(100, 1024, 64), (100, 64, 10)])
def test_b2_block_under_the_sweeps_plan_equals_its_lanes(cuda_device, M, K,
                                                         N):
    """A block of 4 lanes read inside planned_lanes(16) takes the 16-lane
    call's plan, and its lanes' bits (the sweep's config_block)."""
    x, w, br, st, _, seeds = b2_case(cuda_device, 16, M, K, N, False, 6)
    whole = thw.crossbar_forward(x, w, br, st, seeds, 0.05, 2)
    with thw.planned_lanes(16):
        block = thw.crossbar_forward(x, w[4:8], br[4:8], st[4:8],
                                     seeds[4:8], 0.05, 2)
    assert torch.equal(block, whole[4:8])


def test_b2_in_kernel_noise_statistics(cuda_device):
    K = N = 256
    x = torch.eye(K, device=cuda_device)
    w = torch.ones((3, K, N), device=cuda_device)
    zero = torch.zeros_like(w)
    seeds = torch.tensor([1, 2, 99], dtype=torch.int32, device=cuda_device)
    e1 = (thw.crossbar_forward(x, w, zero, zero, seeds, 0.05) - 1) / 0.05
    e2 = (thw.crossbar_forward(x, w, zero, zero, seeds, 0.05) - 1) / 0.05
    assert torch.equal(e1, e2)
    flat = e1.reshape(3, -1).double()
    assert bool((flat.mean(1).abs() < 0.02).all())
    assert bool(((flat.std(1) - 1).abs() < 0.02).all())
    r = torch.corrcoef(flat) - torch.eye(3, dtype=flat.dtype,
                                         device=flat.device)
    assert float(r.abs().max()) < 0.02


def test_b2_crossbar_matmul_autograd_on_card(cuda_device):
    rng = np.random.RandomState(0)
    t = lambda a: torch.from_numpy(a).to(cuda_device)
    x = t(rng.randn(100, 64).astype(np.float32)).requires_grad_()
    w = t((rng.randn(64, 10) * 0.1).astype(np.float32)).requires_grad_()
    broken = t(rng.rand(64, 10) < 0.1)
    stuck = t(rng.choice([-1.0, 0.0, 1.0], size=(64, 10)).astype(np.float32))
    g = t(rng.randn(100, 10).astype(np.float32))
    grads = []
    for use_kernel in (True, False):
        y = thw.crossbar_matmul(x, w, broken, stuck, 3, 0.0, 2, use_kernel)
        grads.append(torch.autograd.grad(y, (x, w), g))
    for a, b in zip(*grads):
        assert torch.equal(a, b)        # the backward is the same code


def tiled_case(device, x_shape, C, K, N, dyadic, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    if dyadic:
        dy = lambda shape, lim: torch.randint(
            -lim, lim + 1, shape, generator=g, device=device).float() / 16
        x, w = dy(x_shape, 16), dy((C, K, N), 12)
        w[:, 0, 0] = 0.75
    else:
        x = torch.randn(x_shape, generator=g, device=device)
        w = torch.randn((C, K, N), generator=g, device=device) * 0.1
    broken = (torch.rand((C, K, N), generator=g, device=device)
              < 0.1).float()
    stuck = torch.randint(-1, 2, (C, K, N), generator=g,
                          device=device).float()
    seeds = torch.arange(3, 3 + C, dtype=torch.int32, device=device)
    return x, w, broken, stuck, seeds


CONV_CASES = [  # x shape (one lane), geom, K, N, tiles
    ((8, 32, 16, 16), (5, 5, 1, 1, 2, 2, 1, 1), 800, 32, (128, 32, 8)),
    ((3, 3, 13, 11), (3, 3, 2, 1, 1, 2, 2, 1), 27, 11, (7, 3, 3)),
]


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("lanes", ["one", "shared", "per_lane"])
def test_b2t_kernel_matches_plain(cuda_device, dyadic, lanes):
    C = 1 if lanes == "one" else 4
    for M, K, N, tiles in ((100, 1024, 64, (128, 64, 8)),
                           (37, 50, 11, (7, 3, 3))):
        x, w, br, st, seeds = tiled_case(
            cuda_device, ((C,) if lanes == "per_lane" else ()) + (M, K), C,
            K, N, dyadic, M)
        for adc in (3, 8):
            t = (tiles[0], tiles[1], adc)
            for sigma in ((0.0,) if dyadic else (0.0, 0.05)):
                y = thw.crossbar_forward(x, w, br, st, seeds, sigma, 2,
                                         tiles=t)
                yp = thw.crossbar_forward_plain(x, w, br, st, seeds, sigma,
                                                2, tiles=t)
                assert torch.equal(y, yp)


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("lanes", ["one", "shared", "per_lane"])
def test_b3_kernel_matches_plain(cuda_device, dyadic, lanes):
    C = 1 if lanes == "one" else 4
    for xs, geom, K, N, tiles in CONV_CASES:
        x, w, br, st, seeds = tiled_case(
            cuda_device, ((C,) if lanes == "per_lane" else ()) + xs, C, K,
            N, dyadic, K)
        for sigma in ((0.0,) if dyadic else (0.0, 0.05)):
            args = (x, w, br, st, seeds, sigma, 2, tiles, geom)
            y = thw.crossbar_conv_forward(*args)
            yp = thw.crossbar_conv_forward_plain(*args)
            assert torch.equal(y, yp)


@pytest.mark.parametrize("conv", [False, True])
@pytest.mark.parametrize("adc", [0, 3])
def test_tiled_reads_with_many_tile_steps_equal_plain(cuda_device, conv,
                                                      adc):
    """B2t and B3 where a lane has more tile steps (gk * gn) than the ADC
    pass keeps in 48 KB of shared memory (12,288; 1-cell crossbar tiles):
    equal to the plain version on dyadic inputs."""
    if conv:
        xs, geom, K, N = (2, 16, 9, 9), (3, 3, 1, 1, 1, 1, 1, 1), 144, 96
    else:
        xs, geom, K, N = (20, 1600), None, 1600, 9
    assert K * N > 12288
    tiles = (1, 1, adc)
    x, w, br, st, seeds = tiled_case(cuda_device, xs, 2, K, N, True, K)
    if conv:
        args = (x, w, br, st, seeds, 0.0, 2, tiles, geom)
        y = thw.crossbar_conv_forward(*args)
        yp = thw.crossbar_conv_forward_plain(*args)
    else:
        y = thw.crossbar_forward(x, w, br, st, seeds, 0.0, 2, tiles=tiles)
        yp = thw.crossbar_forward_plain(x, w, br, st, seeds, 0.0, 2,
                                        tiles=tiles)
    assert torch.equal(y, yp)


@pytest.mark.parametrize("conv", [False, True])
def test_tiled_reads_over_more_lanes_than_a_grid_row_equal_plain(
        cuda_device, conv):
    """B2t and B3 over 65,537 lanes (more than a grid's 65,535 rows; ADC
    3 bits, no weight quantization) equal to the plain version on dyadic
    inputs."""
    C, tiles = 65537, (1, 1, 3)
    if conv:
        xs, geom, K, N = (1, 2, 2, 2), (2, 2, 1, 1, 0, 0, 1, 1), 8, 2
    else:
        xs, geom, K, N = (3, 2), None, 2, 2
    x, w, br, st, seeds = tiled_case(cuda_device, xs, C, K, N, True, 5)
    if conv:
        args = (x, w, br, st, seeds, 0.0, 0, tiles, geom)
        y = thw.crossbar_conv_forward(*args)
        yp = thw.crossbar_conv_forward_plain(*args)
    else:
        y = thw.crossbar_forward(x, w, br, st, seeds, 0.0, 0, tiles=tiles)
        yp = thw.crossbar_forward_plain(x, w, br, st, seeds, 0.0, 0,
                                        tiles=tiles)
    assert torch.equal(y, yp)


B2T_EDGES = [  # M, K, N, tiles: B2t at the edges of its tiling
    (1, 1000, 64, (128, 64, 8)), (100, 1000, 64, (128, 64, 8)),
    (128, 1000, 10, (96, 64, 8)), (100, 256, 130, (128, 64, 8)),
    (100, 300, 64, (128, 32, 8)), (100, 64, 10, (128, 64, 8)),
    (129, 1024, 64, (128, 64, 8)), (37, 50, 11, (7, 3, 3)),
    (96, 96, 96, (7, 5, 3))]


@pytest.mark.parametrize("M,K,N,tiles", B2T_EDGES)
@pytest.mark.parametrize("C,x_batched", [(1, False), (4, False), (4, True)])
def test_b2t_edge_shapes_layouts_and_repeat(cuda_device, M, K, N, tiles, C,
                                            x_batched):
    """B2t at the edges of its tiling (M 1, 128, 129; a short last K-tile;
    bk 96; N 10 and 130; two N-tiles in a block; one K-tile; bn not
    dividing 64): equal to the plain version on dyadic and random inputs;
    every layout equal to the dense f32 call
    and a second call equal to the first."""
    xs = ((C,) if x_batched else ()) + (M, K)
    for dyadic in (True, False):
        x, w, br, st, seeds = tiled_case(cuda_device, xs, C, K, N, dyadic,
                                         M + K)
        y = thw.crossbar_forward(x, w, br, st, seeds, 0.0, 2, tiles=tiles)
        yp = thw.crossbar_forward_plain(x, w, br, st, seeds, 0.0, 2,
                                        tiles=tiles)
        assert torch.equal(y, yp)
        eps = torch.randn(w.shape, device=cuda_device)
        for sigma, e in ((0.0, None), (0.05, eps), (0.05, None)):
            y = thw.crossbar_forward(x, w, br, st, seeds, sigma, 2, eps=e,
                                     tiles=tiles)
            for name, (lx, lw, lb, ls, le) in b2_layouts(x, w, br > 0, st,
                                                         eps).items():
                for _ in range(2):
                    yl = thw.crossbar_forward(
                        lx, lw, lb, ls, seeds, sigma, 2,
                        eps=le if e is not None else None, tiles=tiles)
                    assert torch.equal(yl, y), name


@pytest.mark.parametrize("M,K,N,tiles", B2T_EDGES)
def test_b2t_one_lane_against_lane_0_of_four(cuda_device, M, K, N, tiles):
    """A lane's read does not depend on how many lanes share the call:
    each K-tile's partial is summed in the same order, its ADC and the
    ascending sum are the same whatever tile rows the plan takes."""
    x, w, br, st, seeds = tiled_case(cuda_device, (M, K), 4, K, N, False, 7)
    four = thw.crossbar_forward(x, w, br, st, seeds, 0.05, 2, tiles=tiles)
    one = thw.crossbar_forward(x, w[:1], br[:1], st[:1], seeds[:1], 0.05, 2,
                               tiles=tiles)
    assert torch.equal(one, four[:1])


@pytest.mark.parametrize("M,K,N,tiles", [(100, 1024, 64, (128, 64, 8)),
                                         (100, 64, 10, (128, 64, 8)),
                                         (37, 50, 11, (7, 3, 3))])
def test_b2t_tile_rows_give_the_same_bits(cuda_device, M, K, N, tiles):
    """The GEMM pass's tile heights (32, 112 and 128 rows) give the same
    bits."""
    x, w, br, st, seeds = tiled_case(cuda_device, (M, K), 3, K, N, False, 9)
    ys = [thw._launch_b2t(x, w, br, st, seeds, 0.05, 2, None, tiles, bm=bm)
          for bm in (112, 32, 128)]
    for y in ys[1:]:
        assert torch.equal(y, ys[0])


def test_tiled_launches_are_counted_per_function(cuda_device):
    x, w, br, st, seeds = tiled_case(cuda_device, (3, 2, 7, 7), 2, 18, 4,
                                     True, 0)
    before_b2 = dict(thw.CROSSBAR_LIB.counts)
    thw.crossbar_conv_forward(x, w, br, st, seeds, 0.0, 0, (8, 3, 3),
                              (3, 3, 1, 1, 1, 1, 1, 1))
    thw.crossbar_forward(torch.ones(5, 18, device=cuda_device), w, br, st,
                         seeds, 0.0, 0, tiles=(8, 3, 3))
    # B3 and B2t share B2's source and library, each with its own count
    assert thw.CROSSBAR_LIB.counts["rram_crossbar_implicit_forward"] == \
        before_b2["rram_crossbar_implicit_forward"] + 1
    assert thw.CROSSBAR_LIB.counts["rram_crossbar_tiled_forward"] == \
        before_b2["rram_crossbar_tiled_forward"] + 1
    assert thw.CROSSBAR_LIB.counts["rram_crossbar_forward"] == \
        before_b2["rram_crossbar_forward"]


B3_CASES = [  # one lane's x, geom, K, N, tiles
    ((4, 32, 16, 16), (5, 5, 1, 1, 2, 2, 1, 1), 800, 32, (128, 32, 8)),
    ((4, 32, 8, 8), (5, 5, 1, 1, 2, 2, 1, 1), 800, 64, (128, 64, 8)),
    ((4, 3, 13, 11), (3, 3, 2, 1, 1, 2, 2, 1), 27, 11, (7, 3, 3)),
    ((2, 5, 9, 9), (3, 3, 1, 1, 0, 0, 1, 1), 45, 96, (16, 40, 8))]


@pytest.mark.parametrize("xs,geom,K,N,tiles", B3_CASES)
@pytest.mark.parametrize("lanes", ["single", "shared", "per_lane"])
def test_b3_equals_b2t_over_patch_rows(cuda_device, xs, geom, K, N, tiles,
                                       lanes):
    """B3 over x, and a second call: the bits of B2t over
    `conv_patch_rows(x)` at the same crossbar tiles."""
    from rram_caffe_simulation_tpu_torch.fault.mapping import conv_patch_rows
    C = 1 if lanes == "single" else 4
    x, w, br, st, seeds = tiled_case(
        cuda_device, ((C,) if lanes == "per_lane" else ()) + xs, C, K, N,
        False, 11)
    rows = conv_patch_rows(x, geom)
    want = thw._launch_b2t(rows, w, br, st, seeds, 0.05, 2, None, tiles)
    for _ in range(2):
        assert torch.equal(thw._launch_b3(
            x, w, br, st, seeds, 0.05, 2, None, tiles, geom), want)
    assert torch.equal(thw.crossbar_conv_forward(
        x, w, br > 0, st, seeds, 0.05, 2, tiles, geom), want)


def test_b3_autograd_on_card_equals_premat(cuda_device):
    """The implicit read's backward (patch rows built in the backward)
    against the premat path's on the card: dx and dw equal."""
    from rram_caffe_simulation_tpu_torch.fault.mapping import conv_patch_rows
    geom = (3, 3, 2, 2, 1, 1, 1, 1)
    rng = np.random.RandomState(1)
    t = lambda a: torch.from_numpy(a).to(cuda_device)
    x0 = rng.randn(4, 3, 9, 9).astype(np.float32)
    w0 = (rng.randn(27, 5) * 0.3).astype(np.float32)
    broken = t(rng.rand(27, 5) < 0.1)
    stuck = t(rng.choice([-1.0, 0.0, 1.0], size=(27, 5)).astype(np.float32))
    g = t(rng.randn(4 * 5 * 5, 5).astype(np.float32))
    grads = []
    for implicit in (True, False):
        x, w = t(x0).requires_grad_(), t(w0).requires_grad_()
        if implicit:
            y = thw.crossbar_conv_matmul(x, w, broken, stuck, 3, 0.0, 2,
                                         (8, 3, 8), geom)
        else:
            y = thw.crossbar_matmul(conv_patch_rows(x, geom), w, broken,
                                    stuck, 3, 0.0, 2, tiles=(8, 3, 8))
        grads.append(torch.autograd.grad(y, (x, w), g))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


POOL1 = ((32, 32), (3, 3), (2, 2), (0, 1, 0, 1))


@pytest.mark.parametrize("lead,hw,kernel,stride,fpad,kind,budget", [
    ((100, 32),) + POOL1 + (None, None),                     # pool1, C = 1
    ((100, 16384),) + POOL1 + (None, None),                  # pool1, C = 512
    ((3, 5), (16, 16), (3, 3), (2, 2), (0, 1, 0, 1), None, None),
    ((7,), (16, 16), (3, 3), (2, 2), (0, 1, 0, 1), None, None),  # 7 planes
    ((4, 3), (7, 7), (3, 3), (2, 2), (1, 1, 1, 1), None, None),
    ((2, 3), (9, 11), (3, 2), (1, 2), (0, 1, 1, 1), None, None),
    ((2, 3), (12, 12), (2, 2), (2, 2), (0, 0, 0, 0), None, None),
    ((2, 3), (32, 32), (3, 3), (2, 2), (0, 1, 0, 1), "tie", None),
    ((4, 5),) + POOL1 + ("nan", None),
    ((2, 3), (9, 11), (3, 2), (1, 2), (0, 1, 1, 1), "nan", None),
    ((2, 3), (300, 300), (3, 3), (2, 2), (0, 1, 0, 1), None, None),  # rows
    ((2, 3), (300, 301), (3, 3), (2, 2), (0, 1, 0, 1), "nan", None),
    ((2, 3),) + POOL1 + (None, 4096),                        # row bands
    ((2, 3),) + POOL1 + ("nan", 1024),                       # and columns
    ((2, 3), (9, 11), (3, 2), (1, 2), (0, 1, 1, 1), None, 512),
    ((2, 3), (7, 7), (3, 3), (2, 2), (1, 1, 1, 1), "tie", 256),
])
def test_b4_kernel_equals_plain(cuda_device, lead, hw, kernel, stride, fpad,
                                kind, budget):
    """B4 equals its plain version bit for bit: pool1 at C = 1 and C = 512
    (the only case near 2^31 elements), plane counts off the tile's,
    W not a multiple of 4, all-tie planes, NaN windows, planes banded by
    rows (300 x 300 under the default budget) and, through the private
    launcher under a small budget, by rows and columns."""
    ho = (hw[0] + fpad[2] + fpad[3] - kernel[0]) // stride[0] + 1
    wo = (hw[1] + fpad[0] + fpad[1] - kernel[1]) // stride[1] + 1
    gen = torch.Generator(device=cuda_device).manual_seed(sum(hw))
    x = torch.randn(lead + hw, generator=gen, device=cuda_device)
    g = torch.randn(lead + (ho, wo), generator=gen, device=cuda_device)
    if kind == "tie":
        x.fill_(1.5)
    elif kind == "nan":      # lone NaNs, and windows with two or more
        x[torch.rand(x.shape, generator=gen, device=cuda_device) < 0.05] = \
            float("nan")
        x[..., :2, :2] = float("nan")
    if budget is None:
        dk = tpool.max_pool_backward(x, g, kernel, stride, fpad)
    else:
        plan = tpool.b4_plan(*hw, ho, wo, kernel, stride, fpad, budget=budget)
        assert plan.rows < hw[0] or plan.cols < hw[1]
        dk = tpool._launch_b4(x, g, kernel, stride, fpad, plan)
    dp = tpool.max_pool_backward_plain(x, g, kernel, stride, fpad)
    assert torch.equal(dk.view(torch.int32), dp.view(torch.int32))
    if budget is not None:
        return
    del dk
    # and through the layer's autograd.Function under RRAM_POOL_BWD=cuda
    launches = tpool.POOL_BWD_LIB.launches
    xr = x.clone().requires_grad_()
    y = tpool._MaxPool.apply(xr, kernel, stride, fpad, "cuda")
    (dx,) = torch.autograd.grad(y, xr, g)
    assert tpool.POOL_BWD_LIB.launches == launches + 1
    assert torch.equal(dx.view(torch.int32), dp.view(torch.int32))
