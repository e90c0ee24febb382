"""The reference's random numbers: JAX's threefry2x32 key chain and the
samplers built on it (jax._src.prng, jax._src.random of JAX 0.9, with
`jax_threefry_partitionable` on, its default), so one seed draws the
same params, fault states and crossbar seeds here as in the reference.

Keys stay on the host. A key is a numpy uint32 array of shape (..., 2);
`PRNGKey`, `split`, `fold_in` and `randint` run in numpy over all the
leading axes at once (C lanes are one threefry pass, no device launch).

Bulk draws (`random_bits`, `uniform`, `normal`, `bernoulli`) run on a
tensor device: threefry over the row-major linear index of the output as
(hi, lo) 32-bit counters, in int64 tensors masked to 32 bits (torch's
uint32 lacks most operators, on CUDA above all). A batch of keys
(..., 2) draws key.shape[:-1] + shape, one block per key, as jax.vmap
over the keys does. A draw of fewer than SMALL_DRAW elements runs on the
host and is copied over, so a per-step bias draw costs no launches; the
bits are the same either way.

The floats come from IEEE basic operations only (+ - * /, sqrt, nextafter,
compares, bit views), which round alike on the CPU and the card, so a
draw is bit-identical on both. XLA's CPU backend, where the reference
draws, contracts a multiply that feeds an add into a fused multiply-add
(LLVM fp-op fusion, for a product with one use); `fma` computes that
correctly rounded float32 fma from float64 operations (round to odd),
and is used exactly where the reference's code is fused. `normal` is
sqrt(2) * erf_inv(u), u uniform on (-1, 1): erf_inv is Giles'
single-precision polynomial (XLA's ErfInv for f32) and its log1p is
XLA's CPU log1p (Cephes' rational below sqrt(2) - 1, else Eigen's plog
of 1 + x). `exp` and `log1p` are XLA's CPU float32 exp and log1p, for
the fault processes that compute with them (fault/processes/drift.py).
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
# draws below this many elements run on the host (then one copy)
SMALL_DRAW = 4096
INT32_MAX = 2 ** 31 - 1

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


# ---------------------------------------------------------------------------
# threefry2x32, 20 rounds

def _threefry_np(k1, k2, x1, x2):
    """threefry2x32 on numpy uint32 arrays (broadcast together), as
    in-place uint32 ufuncs on 1-D arrays (numpy wraps uint32 arrays mod
    2^32 but warns on scalar overflow)."""
    arrs = [np.asarray(a, dtype=np.uint32) for a in (k1, k2, x1, x2)]
    shape = np.broadcast_shapes(*(a.shape for a in arrs))
    k1, k2, x1, x2 = (np.array(np.broadcast_to(a, shape), dtype=np.uint32)
                      .reshape(-1) for a in arrs)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(_PARITY))
    a, b = x1 + ks[0], x2 + ks[1]
    t = np.empty_like(b)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            np.add(a, b, out=a)
            np.left_shift(b, np.uint32(r), out=t)
            np.right_shift(b, np.uint32(32 - r), out=b)
            np.bitwise_or(b, t, out=b)
            np.bitwise_xor(b, a, out=b)
        np.add(a, ks[(i + 1) % 3], out=a)
        np.add(b, ks[(i + 2) % 3], out=b)
        np.add(b, np.uint32(i + 1), out=b)
    return a.reshape(shape), b.reshape(shape)


def _threefry_t(k1, k2, x1, x2):
    """threefry2x32 on int64 tensors holding uint32 values (keys
    broadcast against the counters); returns two new int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]).bitwise_and_(MASK32)
    b = (x2 + ks[1]).bitwise_and_(MASK32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a.add_(b).bitwise_and_(MASK32)
            b = (b << r).bitwise_and_(MASK32).bitwise_or_(b >> (32 - r))
            b.bitwise_xor_(a)
        a.add_(ks[(i + 1) % 3]).bitwise_and_(MASK32)
        b.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK32)
    return a, b


# ---------------------------------------------------------------------------
# keys, on the host

def PRNGKey(seed: int) -> np.ndarray:
    """jax.random.PRNGKey: the seed's 64 bits as (hi, lo) words."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & MASK32], dtype=np.uint32)


def _words(key):
    key = np.asarray(key, dtype=np.uint32)
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key is (..., 2) uint32, got shape {key.shape}")
    return key[..., 0], key[..., 1]


def split(key, num: int = 2) -> np.ndarray:
    """jax.random.split: (..., 2) keys -> (..., num, 2); key i is
    threefry over the counter (0, i)."""
    k1, k2 = _words(key)
    i = np.arange(num, dtype=np.uint32)
    a, b = _threefry_np(k1[..., None], k2[..., None], np.uint32(0), i)
    return np.stack([a, b], axis=-1)


def fold_in(key, data) -> np.ndarray:
    """jax.random.fold_in: threefry over the counter (0, data); `data`
    (an int or an integer array) broadcasts against the key's leading
    axes, taken mod 2^32."""
    k1, k2 = _words(key)
    d = (np.asarray(data, dtype=np.int64) & MASK32).astype(np.uint32)
    a, b = _threefry_np(k1, k2, np.uint32(0), d)
    return np.stack([a, b], axis=-1)


def _bits_np(key) -> np.ndarray:
    """32 random bits of shape () per key (the counter (0, 0))."""
    k1, k2 = _words(key)
    a, b = _threefry_np(k1, k2, np.uint32(0), np.uint32(0))
    return a ^ b


def randint(key, minval: int = 0, maxval: int = INT32_MAX) -> np.ndarray:
    """jax.random.randint(key, (), minval, maxval) as int32, one per key
    (shape key.shape[:-1]): two 32-bit draws from split(key) combined
    by JAX's span/multiplier arithmetic, in uint32 that wraps."""
    if not (-2 ** 31 <= minval <= INT32_MAX and -2 ** 31 <= maxval
            <= INT32_MAX):
        raise ValueError(f"randint bounds ({minval}, {maxval}) must fit "
                         "int32")
    ks = split(key)
    hi = _bits_np(ks[..., 0, :]).astype(np.uint64)
    lo = _bits_np(ks[..., 1, :]).astype(np.uint64)
    span = 1 if maxval <= minval else (maxval - minval) & MASK32
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK32) % span
    off = (((hi % span) * np.uint64(mult)) & np.uint64(MASK32)) \
        + (lo % span)
    off = (off & np.uint64(MASK32)) % span
    return ((off.astype(np.int64) + minval) & MASK32).astype(
        np.uint32).view(np.int32)


# ---------------------------------------------------------------------------
# bulk draws, on a tensor device

def _draw_device(key, shape, device):
    """(key array, batch shape, draw shape, the device the draw runs on,
    the device it is returned on): the host below SMALL_DRAW elements."""
    key = np.asarray(key, dtype=np.uint32)
    shape = tuple(int(d) for d in shape)
    device = torch.device(device)
    total = math.prod(key.shape[:-1]) * math.prod(shape)
    run_on = device if total >= SMALL_DRAW else torch.device("cpu")
    return key, key.shape[:-1], shape, run_on, device


def _place(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` on `device`; a host tensor goes to the card through pinned
    memory, so the copy does not wait for the stream."""
    if t.device.type == device.type:
        return t.to(device)               # "cuda" and "cuda:0": no copy
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _bits(key, batch, shape, run_on) -> torch.Tensor:
    kt = torch.from_numpy(np.ascontiguousarray(
        key.reshape(-1, 2)).astype(np.int64)).to(run_on)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=run_on)[None]
    a, b = _threefry_t(kt[:, :1], kt[:, 1:], idx >> 32, idx & MASK32)
    return a.bitwise_xor_(b).reshape(batch + shape)


def random_bits(key, shape, device="cpu") -> torch.Tensor:
    """32 random bits per element as an int64 tensor in [0, 2^32), of
    shape key.shape[:-1] + shape: threefry over the row-major index's
    (hi, lo) words, the two outputs XORed."""
    key, batch, shape, run_on, device = _draw_device(key, shape, device)
    return _place(_bits(key, batch, shape, run_on), device)


def _f32(x) -> float:
    return float(np.float32(x))


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """The correctly rounded float32 a * b + c (a float32 tensor; b, c
    tensors or floats of float32 value), from float64 basic operations:
    the product is exact in float64, the sum is rounded to odd (TwoSum
    gives its error; an inexact sum with an even last bit steps one ulp
    towards the exact value), and round-to-odd at 53 bits then
    round-to-nearest at 24 is the correct rounding."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    p = a.double() * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even_inexact = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.nextafter(s, err * math.inf)     # one ulp towards exact
    return torch.where(even_inexact, toward, s).float()


def _sqrt(w: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 sqrt of w >= 0. torch's CPU sqrt
    (vectorised, either precision) is not always correctly rounded, so
    a float64 sqrt rounded to float32 is checked against the two
    neighbouring midpoints, whose squares are exact in float64."""
    w64 = w.double()
    s = torch.sqrt(w64).float()
    bits = s.view(torch.int32)
    up = (bits + 1).view(torch.float32)
    down = (bits - 1).view(torch.float32)
    s64 = s.double()
    mid_up = (s64 + up.double()) * 0.5
    mid_down = (s64 + down.double()) * 0.5
    pos = s > 0
    go_up = pos & (mid_up * mid_up <= w64)
    go_down = pos & (mid_down * mid_down >= w64)
    return torch.where(go_up, up, torch.where(go_down, down, s))


def _is_pow2(x: float) -> bool:
    return x != 0 and math.frexp(abs(x))[0] == 0.5


def _uniform(key, batch, shape, run_on, minval, maxval) -> torch.Tensor:
    lo, hi = _f32(minval), _f32(maxval)
    span = _f32(np.float32(hi) - np.float32(lo))
    bits = _bits(key, batch, shape, run_on)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if _is_pow2(span):
        y = f * span + lo          # the product is exact: fma == mul, add
    else:
        y = fma(f, span, lo)
    return torch.clamp_min(y, lo)


def uniform(key, shape, minval=0.0, maxval=1.0, device="cpu"):
    """jax.random.uniform in float32: the top 23 bits as the mantissa of
    a float in [1, 2), minus 1, then max(lo, f * (hi - lo) + lo) with
    the reference's fused multiply-add."""
    key, batch, shape, run_on, device = _draw_device(key, shape, device)
    return _place(_uniform(key, batch, shape, run_on, minval, maxval),
                  device)


def bernoulli(key, p: float, shape, device="cpu") -> torch.Tensor:
    """jax.random.bernoulli (mode "low") with a float32 p: uniform < p."""
    key, batch, shape, run_on, device = _draw_device(key, shape, device)
    return _place(_uniform(key, batch, shape, run_on, 0.0, 1.0) < _f32(p),
                  device)


def normal(key, shape, device="cpu") -> torch.Tensor:
    """jax.random.normal in float32: sqrt(2) * erf_inv(u), u uniform on
    [nextafter(-1, 0), 1)."""
    key, batch, shape, run_on, device = _draw_device(key, shape, device)
    u = _uniform(key, batch, shape, run_on, _NORMAL_LO, 1.0)
    return _place(_erf_inv(u) * _SQRT2, device)


def normal_fma(key, shape, scale: float, shift: float, device="cpu"):
    """scale * normal(key) + shift as the reference computes it inside a
    jitted step: XLA folds sqrt(2) * scale into one float32 constant and
    the add into a fused multiply-add, fma(erf_inv(u), c, shift)."""
    key, batch, shape, run_on, device = _draw_device(key, shape, device)
    u = _uniform(key, batch, shape, run_on, _NORMAL_LO, 1.0)
    c = _f32(np.float32(_SQRT2) * np.float32(scale))
    return _place(fma(_erf_inv(u), c, _f32(shift)), device)


# XLA's f32 ErfInv (Giles, "Approximating the erfinv function"): the
# Horner coefficients for w < 5, then for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# Eigen's plog (Cephes logf) and XLA's small-x log1p rational (Cephes)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRT_HALF = 0.707106781186547524
_MIN_NORMAL = float(np.finfo(np.float32).tiny)
_LOG1P_SMALL = 0.41421356237309504880          # sqrt(2) - 1
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_SQRT2 = _f32(math.sqrt(2.0))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def _log_plog(v: torch.Tensor) -> torch.Tensor:
    """Eigen's plog of v as XLA's CPU backend computes it: the exponent
    split off, the mantissa in [sqrt(1/2), sqrt(2)), three interleaved
    Horner chains; 0 -> -inf, inf -> inf, < 0 or nan -> nan."""
    m_in = torch.where(v > _MIN_NORMAL, v, _MIN_NORMAL)
    ib = m_in.view(torch.int32)
    e = ((ib >> 23) - 127).float() + 1.0
    m = ((ib & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _f32(_SQRT_HALF)
    x = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - torch.where(small, 1.0, 0.0)
    x2 = x * x
    x3 = x2 * x
    P = [_f32(c) for c in _LOG_P]
    y = fma(fma(x, P[0], P[1]), x, P[2])
    y1 = fma(fma(x, P[3], P[4]), x, P[5])
    y2 = fma(fma(x, P[6], P[7]), x, P[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, e * _f32(_LOG_Q1))
    r = (x - x2 * 0.5) + y
    r = r + e * _LOG_Q2                    # an exact product
    inf = float("inf")
    r = torch.where((v <= 0) | torch.isnan(v), float("nan"), r)
    r = torch.where(v == inf, inf, r)
    return torch.where(v == 0, -inf, r)


def _log1p_small(x: torch.Tensor) -> torch.Tensor:
    """Cephes' rational log1p of |x| < sqrt(2) - 1, XLA's fused steps."""
    zero = x * 0.0
    den = zero + 1.0
    for c in _LOG1P_DEN[1:]:
        den = fma(den, x, _f32(c))
    num = zero + _f32(_LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = fma(num, x, _f32(c))
    xx = x * x
    # the fused x^2 * -0.5 + t has an exact product: a plain add
    return x + (xx * -0.5 + (x * xx) * (num / den))


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU log1p in float32: Cephes' rational where |x| < sqrt(2)
    - 1, else log(1 + x)."""
    return torch.where(x.abs() < _f32(_LOG1P_SMALL), _log1p_small(x),
                       _log_plog(x + 1.0))


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU log1p of a float32 tensor (`_log1p`)."""
    return _log1p(x)


# XLA's CPU f32 exp (its polynomial_approximations: Cephes' expf)
_EXP_LO, _EXP_HI = _f32(-87.8), _f32(88.8)
_LOG2E = _f32(1.44269504088896341)
_EXP_C1, _EXP_C2 = _f32(0.693359375), _f32(-2.12194440e-4)
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU exp of a float32 tensor, bit for bit: x clamped to
    [-87.8, 88.8], n = floor(x log2(e) + 1/2) clamped to [-127, 127],
    a = x - n ln 2 in two fused steps, Cephes' degree-6 polynomial for
    e^a with XLA's fused steps, times 2^n built from the exponent bits;
    a subnormal result flushes to 0 (XLA's CPU code runs with denormals
    off)."""
    xc = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(fma(xc, _LOG2E, 0.5)), -127.0, 127.0)
    a = fma(n, -_EXP_C1, xc)
    a = fma(n, -_EXP_C2, a)
    p = fma(a, _f32(_EXP_P[0]), _f32(_EXP_P[1]))
    for c in _EXP_P[2:]:
        p = fma(p, a, _f32(c))
    z = fma(p, a * a, a) + 1.0
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    y = z * pow2
    return torch.where(y.abs() < _MIN_NORMAL, 0.0, y)


def _giles(coefs, shift):
    """Giles' polynomial in shift(w), Horner with XLA's fused steps."""
    def poly(w):
        t = shift(w)
        p = fma(t, _f32(coefs[0]), _f32(coefs[1]))
        for c in coefs[2:]:
            p = fma(p, t, _f32(c))
        return p
    return poly


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ErfInv: w = -log1p(-x^2), then Giles' polynomial in
    w - 2.5 (w < 5) or sqrt(w) - 3, times x; +-inf at |x| = 1."""
    w = -_log1p(x * -x)
    p = torch.where(w < 5.0, _giles(_ERFINV_LT5, lambda v: v - 2.5)(w),
                    _giles(_ERFINV_GE5, lambda v: _sqrt(v) - 3.0)(w))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)
