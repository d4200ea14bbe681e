"""A whole run of each cell on the CPU, at a frame a test can hold: the
harness drives the program's plain version through set-up, the window and
the check (it skips the look for a card). A sound run is correct and its
control, the reference in bfloat16, is not; a run with the timed path broken
underneath is not correct, for each fault a cell can have:

- a step that returns its state unchanged (``Renderer.trace`` does
  nothing);
- half of the batch left out and the mean taken over the rest (each
  dispatch traces half its samples and counts them twice);
- an answer altered where it is produced (every value of the kernel's
  output one ulp up).

A cell on one card has no exchange between cards to leave out."""

import pytest
import torch
from helpers_vrbench import small_cell

from vrbench.check import LIMITS
from vrbench.run import run_cell

SEED = 2_147_483_999


def _run(cell, seconds=0.2):
    return run_cell(cell, SEED, seconds, False, device="cpu", control=True, t0=0.0)


@pytest.mark.parametrize("name", ["cloud512.offline", "cloud512_fire.interactive"])
def test_a_sound_run_is_correct_and_its_control_is_not(name):
    res = _run(small_cell(name, spp=2 if name.endswith("interactive") else 3))
    assert res["correct"] is True and res["failed"] == 0
    assert res["check"]["values_differing"] == {"value": 0, "limit": 0}
    assert set(res["metrics"]) == ({"spp_s", "setup_s"} if name.endswith("offline")
                                   else {"step_ms_p95", "setup_s"})
    control = res["control"]
    assert control["values_differing"] > LIMITS["values_differing"]
    assert control["max_abs_diff"] > LIMITS["max_abs_diff"]


def _state_unchanged(monkeypatch):
    from volren_tpu_torch.renderer import Renderer

    monkeypatch.setattr(Renderer, "trace", lambda self, spp=1: None)


def _half_the_batch(monkeypatch):
    from volren_tpu_torch.parallel import sharding

    real = sharding.render_sharded

    def half(ks, pool, params, width, height, spp, spp_base, mesh):
        kept = max(1, spp // 2)
        return real(ks, pool, params, width, height, kept, spp_base, mesh) * (spp / kept)

    monkeypatch.setattr(sharding, "render_sharded", half)


def _answer_altered(monkeypatch):
    from volren_tpu_torch.ops.kernels import megakernel

    real = megakernel.render
    monkeypatch.setattr(megakernel, "render", lambda *a: torch.nextafter(
        real(*a), torch.tensor(float("inf"))))


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch, _answer_altered])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = run_cell(small_cell("cloud512_fire.interactive", spp=2), SEED, 0.2, False,
                   device="cpu", t0=0.0)
    assert res["correct"] is False
    assert res["check"]["values_differing"]["value"] > 0
