"""The control on a card, at a size a test run holds: the program's run
passes every limit, and the reference computed with TF32 matmuls fails
at least one. The same comparison at each cell's own size runs through
``python3 -m slambench.control``."""
import pytest
import torch

from slambench import run as srun
from slambench.reference import check
from slambench.tests.test_slambench_faults import _small_ba


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 12, 13])
def test_tf32_control_fails_a_limit(card, seed):
    man = srun.manifest()
    cell = srun.cell_of(man, "tum_fr1_mono.xyz")
    cfg_doc, tr = _small_ba()
    tr["ceiling_frames_per_s"] = 500       # the small step runs fast on a card
    result, rows, _, other = srun.run_cell(
        man, cell, seed, 3.0, False, device=card, controls=("tf32",),
        cfg_doc=cfg_doc, tr=tr)
    assert result["correct"], rows
    control = other["tf32"]
    lim = check.limits()
    assert any(k in lim and v > lim[k] for k, v in control.items()), \
        (control, lim)
