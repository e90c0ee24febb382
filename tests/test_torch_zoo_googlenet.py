"""GoogLeNet (models/bvlc_googlenet) trains from quick_solver.prototxt in
the port's Solver, 3 steps in lockstep with the reference's on the CPU
(tests/test_torch_zoo.py `lockstep`: losses within 1e-4 relative, banks
exact but for exact-0 writes, params and history within rtol 1e-4 /
atol 1e-6): the stand-in LMDB at batch 2, crop 224 with mirror, every
num_output but the classifiers' 1000 divided by 16, faults on the five
InnerProduct layers of the three heads at N(250, 120). The path: nine
inception towers (Concat), LRN, AVE and MAX pools, three Dropouts and
three losses weighted 0.3, 0.3 and 1.0. Its auxiliary heads read rows
of zeros through the ternary crossbar beside biases stuck at 0, so
their ReLUs meet exact zeros: the reference's jnp.maximum passes half
the cotangent there, and so does the port's ReLU (ROADMAP §C 8)."""
from test_torch_zoo import lockstep, no_x64, one_torch_thread, standin  # noqa: F401,E501
from test_torch_zoo import zoo_solver_text


def test_trains_in_lockstep_with_the_reference(monkeypatch, standin):
    ts, apart, _ = lockstep(monkeypatch,
                            zoo_solver_text("googlenet", standin), 3)
    assert [k for k in ts._fault_keys if k.endswith("/0")] == [
        "loss1/fc/0", "loss1/classifier/0", "loss2/fc/0",
        "loss2/classifier/0", "loss3/classifier/0"]
    assert sum(ly.type_name == "Dropout" for ly in ts.net.layers) == 3
    assert ts.broken_fraction() > 0 and apart <= 40
