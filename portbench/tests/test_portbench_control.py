"""The control: the reference in fp8, put in the program's place, has to
come out not correct.  At the cells' own sizes on the card (``-m cuda``;
the readings the limits were set from are in PERF.md), and at a size the
CPU holds, where the program runs in bfloat16."""
import pytest
import torch

from portbench import bench, spec

from cpu_cell import overrides

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def control_of(check: str) -> str:
    """The control's reading of a compared number (``logit_gap_mean`` ->
    ``control_gap_mean``)."""
    return "control" + check[len("logit"):]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fp8_control_reads_far_above_the_program_on_the_cpu(seed):
    torch.set_num_threads(2)
    r = bench.run_cell("granite-3-8b.sharegpt.r80", seed, 6.0, False,
                       device="cpu", overrides=overrides(dtype="bfloat16"),
                       control=True, log=lambda msg: None)
    c = r["_extra"]["compare"]
    assert c["compared_tokens"] >= 300
    assert c["control_gap"] >= 3 * c["logit_gap"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_fp8_control_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = bench.run_cell(cell, 7, spec.benchmark()["run_seconds"], False,
                       control=True, log=lambda msg: None)
    c = r["_extra"]["compare"]
    held = [k for k in r["checks"] if k.startswith("logit_gap")]
    assert held and r["correct"], r["checks"]
    assert any(c[control_of(k)] > r["checks"][k]["limit"] for k in held), \
        {control_of(k): c[control_of(k)] for k in held}
