"""A small rehearsal of each cell on the CPU (the port's plain twins), with
the harness's look for a card skipped: set-up, one window, the check,
judged as ``run.py`` judges it (``harness.judge``).  Sound runs come out
correct; the control (the reference in bfloat16), each fault a cell can
have, planted in the program underneath, and a check that could not
capture what it compares come out not correct.  The same at a larger size
on the card (marked ``cuda``)."""

import pytest

from portbench import harness
from portbench.drivers import time_stream

TINY_PILE = dict(width=48, height=32, particles=48)


def pile(traffic, seed, device="cpu", size=TINY_PILE):
    run = time_stream.Run(harness.config("dem_pile"),
                          harness.traffic(traffic), seed, device, size=size)
    run.setup()
    stats = run.window(0.0)
    run.release()
    return run, stats


def correct(run, stats, cell, numbers=None):
    numbers = run.check() if numbers is None else numbers
    return harness.judge(cell, numbers, stats["attempted"],
                         stats["failed"])[0]


CELLS = {"whitted_stream": "pile_whitted_anim",
         "path_stream": "pile_path_anim"}


@pytest.mark.parametrize("traffic", sorted(CELLS))
def test_pile_cell_rehearses_correct(traffic):
    run, stats = pile(traffic, 2_147_483_659)
    assert stats["attempted"] == 4 and stats["failed"] == 0
    assert len(run.checked()) == run.required() == 2   # the start, a window chunk
    numbers = run.check()
    assert numbers["schedule"] == 0 and numbers["unchecked"] == 0
    assert correct(run, stats, CELLS[traffic], numbers), numbers


def _not_captured(monkeypatch):
    """The program reaches its chunk by another name than the one the
    check wraps: nothing is recorded."""
    monkeypatch.setattr(time_stream.Run, "_chunk",
                        lambda self, *a, **k: self.real_chunk(*a, **k))


def _frame_missing(run):
    r = run.chunks[run.kept[0]]
    del run.frames[r["start"] + 1]


MISSES = {
    "not_captured": None,
    "no_history_out": lambda run: run.chunks[run.kept[0]].update(t_out=None),
    "no_history_in": lambda run: run.chunks[run.kept[0]].update(t_in=None),
    "frame_missing": _frame_missing,
}


@pytest.mark.parametrize("miss", sorted(MISSES))
def test_pile_check_that_captures_nothing_is_not_correct(monkeypatch, miss):
    if miss == "not_captured":
        _not_captured(monkeypatch)
    run, stats = pile("whitted_stream", 2_147_483_701)
    if MISSES[miss] is not None:
        MISSES[miss](run)
    numbers = run.check()
    assert numbers["unchecked"] >= 1
    assert not correct(run, stats, "pile_whitted_anim", numbers)


def test_judge_wants_every_number_of_the_limits():
    ok = dict(frame_px_share=0.0, history_share=0.0, schedule=0.0,
              unchecked=0.0)
    assert harness.judge("pile_whitted_anim", ok, 4, 0)[0]
    assert not harness.judge("pile_whitted_anim", ok, 0, 0)[0]
    assert not harness.judge("pile_whitted_anim", ok, 4, 1)[0]
    for k in ok:
        part = {x: v for x, v in ok.items() if x != k}
        assert not harness.judge("pile_whitted_anim", part, 4, 0)[0]


def _half_left_out(monkeypatch, module, name):
    real = getattr(module, name)

    def half(*args, **kw):
        out = real(*args, **kw)
        img = out[0].clone()
        img[img.shape[0] // 2:] = 0.0
        return (img,) + tuple(out[1:])
    monkeypatch.setattr(module, name, half)


def _state_unchanged(monkeypatch):
    from optix_ray_tracer_tpu_torch.render import temporal
    monkeypatch.setattr(temporal, "temporal_blend",
                        lambda state, irr, *a, **k: (irr, state))


def _answer_altered(monkeypatch):
    """Each frame's bytes replaced by the frame's before it (a stale
    buffer delivered again)."""
    from optix_ray_tracer_tpu_torch.models import fused
    real = fused.color_to_uint8
    last = []

    def stale(rgb):
        out = real(rgb)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    monkeypatch.setattr(fused, "color_to_uint8", stale)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_pile_faults_come_out_not_correct(monkeypatch, fault):
    from optix_ray_tracer_tpu_torch.render import wavefront
    if fault == "state_unchanged":
        _state_unchanged(monkeypatch)
    elif fault == "half_left_out":
        _half_left_out(monkeypatch, wavefront, "render")
    else:
        _answer_altered(monkeypatch)
    run, stats = pile("whitted_stream", 2_147_483_671)
    assert not correct(run, stats, "pile_whitted_anim")


def split(readings):
    return [{k.split(".", 1)[1]: v for k, v in readings.items()
             if k.startswith(side + ".")} for side in ("program", "control")]


def test_pile_control_comes_out_not_correct():
    run, stats = pile("whitted_stream", 2_147_483_693)
    low, high = split(run.control())
    assert correct(run, stats, "pile_whitted_anim", low)
    assert not correct(run, stats, "pile_whitted_anim", high)


def test_run_py_control_line_reads_not_correct(monkeypatch, capsys,
                                              tmp_path):
    """``run.py --control`` on the CPU, its look for a card skipped: the
    result line judges the control's numbers and reads not correct."""
    import json
    import sys

    import torch

    sys.path.insert(0, str(harness.HERE))
    import run as run_py
    real = time_stream.Run

    class Tiny(real):
        def __init__(self, cfg, mix, seed, device):
            super().__init__(cfg, mix, seed, "cpu", size=TINY_PILE)

    monkeypatch.setattr(time_stream, "Run", Tiny)
    monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(harness, "device_block", lambda n: {
        "platform": "gpu", "kind": "cpu", "count": n,
        "memory_peak_bytes": 0})
    rc = run_py.main(["--workload", "pile_whitted_anim", "--seed",
                      "2147483723", "--seconds", "0", "--trace", "0",
                      "--control"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(harness.limits("pile_whitted_anim"))


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", sorted(CELLS))
def test_pile_on_the_card(card, traffic):
    """The pile at 320x240 with 512 particles on the card: the program's
    kernels pass, the control does not."""
    run, stats = pile(traffic, 3_000_000_019, card,
                      dict(width=320, height=240, particles=512))
    assert stats["attempted"] >= 4
    readings = run.control()
    lim = harness.limits(CELLS[traffic])
    for k in ("frame_px_share", "history_share"):
        assert readings[f"program.{k}"] <= lim[k]
    assert any(readings[f"control.{k}"] > lim[k]
               for k in ("frame_px_share", "history_share"))
