"""The plain reference against the program on the CPU at a small size,
through a whole run of the harness (the window, the seeded sample, the
comparison), and the control: the program's bf16 path fails it."""
import pytest
import torch

from benchmark.reference.add import Arch, all_specs, image_segments, segment_names
from benchmark.weights import make_weights

from .conftest import run_tiny, tiny_cell

CELLS = ("add_c2.xla.exit70", "add_c4.xla.exit70", "add_c2.flat.exit70")


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_reference(name):
    rec = run_tiny(name, seed=2 ** 31 + 11)
    values = {k: c["value"] for k, c in rec["checks"].items()}
    assert rec["correct"], values
    assert values["logits_rel_err"] < 1e-5 and values["conf_rel_err"] < 1e-5
    assert rec["completed"] >= 10 and rec["failed"] == 0


@pytest.mark.parametrize("name", ("add_c2.xla.exit70", "add_c4.xla.exit70"))
def test_bf16_control_fails(name):
    rec = run_tiny(name, seed=7, variant="bf16")
    assert not rec["correct"]
    assert rec["checks"]["logits_rel_err"]["value"] > rec["checks"]["logits_rel_err"]["limit"]


@pytest.mark.parametrize("name", ("add_c2.xla.exit70", "add_c4.xla.exit70"))
def test_port_loads_the_reference_names(name):
    """Every raw weight the reference names is a parameter of the program,
    of the same shape, and none is missing (a strict load)."""
    from auto_dynamic_deeplab_torch.models import ADD, EDM

    cell = tiny_cell(name)
    cfg = cell["config"]
    flat = make_weights(all_specs(Arch(cfg)), 3, "cpu")
    model = ADD(cfg["network_path"], cfg["C_index"], cfg["genotype"], cfg["num_classes"], F=cfg["F"], B=cfg["B"])
    edm = EDM(model.feature_channels(model.exit_layers[0]))
    model.load_state_dict({k[6:]: v for k, v in flat.items() if k.startswith("model.")})
    edm.load_state_dict({k[4:]: v for k, v in flat.items() if k.startswith("edm.")})


def test_weights_are_seeded_and_spread():
    specs = all_specs(Arch(tiny_cell("add_c2.xla.exit70")["config"]))
    a, b, c = (make_weights(specs, s, "cpu") for s in (9, 9, 10))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["model.stems.stem0_conv.kernel"], c["model.stems.stem0_conv.kernel"])
    var = a["model.cell_0.preprocess.bn.var"]
    assert var.min() >= 0.5 and var.max() < 2.0
    k = a["model.decoder.conv2.kernel"]
    assert abs(float(k.std()) - (2.0 / (256 * 9)) ** 0.5) < 2e-3


def test_segments_of_an_image():
    arch = Arch(tiny_cell("add_c4.xla.exit70")["config"])
    assert segment_names(arch) == ["decide_0", "decide_1", "decide_2", "head_0", "head_1", "head_2", "final"]
    assert image_segments(arch, 0) == ["decide_0", "head_0"]
    assert image_segments(arch, 3) == ["decide_0", "decide_1", "decide_2", "final"]
