"""The engine tick's receive (``kernels/receive.py::deliver``) on the CPU:
its plain version against a loop that delivers one message at a time,
for every idempotent form (min, max, or; int32 and float32 with negative
floats) and every layout the engine hands it (contiguous buffers, the
exchange's transposed views, holes inside rows, all slots empty,
duplicate targets, ties that are not accepted, the last vertex id).
The CUDA kernel is held to this plain version on the card
(``test_torch_gpu.py``)."""
import pytest

torch = pytest.importorskip("torch")

import _receive_cases as RC  # noqa: E402
from repro_torch.core.semiring import AGGREGATORS  # noqa: E402
from repro_torch.kernels import receive  # noqa: E402


@pytest.mark.parametrize("layout", RC.LAYOUTS)
@pytest.mark.parametrize("form", RC.FORMS, ids=RC.form_id)
def test_deliver_matches_loop(form, layout):
    name = form[0]
    case = RC.make_case(form, layout, "cpu", seed=RC.LAYOUTS.index(layout))
    before = [t.clone() for t in case]
    launches = receive.deliver.launches
    got = receive.deliver(AGGREGATORS[name], *case)
    want = RC.deliver_loop(name, *case)
    for g, w, field in zip(got, want, ("values", "active", "cursor",
                                       "accepted")):
        assert g.dtype == w.dtype and torch.equal(g, w), field
    for b, t in zip(before, case):  # the inputs are left as they were
        assert torch.equal(b, t)
    assert receive.deliver.launches == launches  # the CPU never launches
    if layout == "all_empty":
        assert int(got[3].sum()) == 0
    elif layout == "ties":
        assert int(got[3].sum()) < int((case[4] >= 0).sum())
