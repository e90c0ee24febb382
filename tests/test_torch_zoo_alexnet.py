"""AlexNet and CaffeNet (models/bvlc_alexnet, models/bvlc_reference_caffenet)
train from their own solver.prototxt in the port's Solver, 3 steps in
lockstep with the reference's on the CPU (tests/test_torch_zoo.py
`lockstep`: losses within 1e-4 relative, banks exact but for exact-0
writes): the stand-in LMDB at batch 2, crop 227 with mirror, the mean
as values, every num_output but fc8's 1000 divided by 16 (tests/
test_torch_zoo.py NARROW), faults on fc6, fc7 and fc8 at N(250, 120).
The path: LRN across channels, group-2 convolutions, overlapping max
pools, two Dropouts drawing from the step key."""
import pytest

from test_torch_zoo import lockstep, no_x64, one_torch_thread, standin  # noqa: F401,E501
from test_torch_zoo import zoo_solver_text


@pytest.mark.parametrize("name", ["alexnet", "caffenet"])
def test_trains_in_lockstep_with_the_reference(monkeypatch, standin, name):
    ts, apart, _ = lockstep(monkeypatch, zoo_solver_text(name, standin),
                            3)
    assert ts._fault_keys == ["fc6/0", "fc6/1", "fc7/0", "fc7/1", "fc8/0",
                              "fc8/1"]
    drops = [ly.name for ly in ts.net.layers if ly.type_name == "Dropout"]
    assert drops == ["drop6", "drop7"]
    assert ts.broken_fraction() > 0 and apart <= 20
