"""Each comparison's control comes out as not correct: the reference put in
the program's place in the precision below the configuration's (the step
in bfloat16 for the f32 step; the f64 Stokes states held in f32), while
the program's own readings pass.  On the CPU at maxh 0.6 for the step; on
the card at the cells' own size (``perfbench/control.py`` gives the
readings of a dozen seeds there)."""

import json
from pathlib import Path

import pytest
import torch

from perfbench import control

REPO = Path(__file__).resolve().parents[2]


def _limits(config):
    spec = json.loads((REPO / f"perfbench/configs/{config}.json")
                      .read_text())
    return spec["limits"]


def _assert_separated(out, limits):
    for name, r in out["readings"].items():
        assert r["program"] <= limits[name], (name, r)
        assert r["control"] > limits[name], (name, r)


def test_mcs_control_fails_small():
    out = control.readings("mcs3d.simple", 2**31 + 99, 0.1, device="cpu",
                           overrides={"maxh": 0.6})
    _assert_separated(out, _limits("mcs3d-cyl-h0.09"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell,config", [("mcs3d.simple", "mcs3d-cyl-h0.09"),
                                         ("hdg3d.stokes", "hdg3d-cyl-h0.09")])
def test_control_fails_at_cell_size_on_card(cell, config):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells' own size")
    out = control.readings(cell, 2**31 + 101, 2.0, device="cuda")
    _assert_separated(out, _limits(config))
