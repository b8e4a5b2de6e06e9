"""The Time frontend's frame stream: a DEM pile's pose series rendered
through ``models/renderer_time.render_frames(data, loop=True,
quantize=True)``, the fused loop that the CLI and the viewer consume
(per-file device rebuild, per-frame refit, integrator, temporal blend,
a-trous, sRGB bytes fetched to the host a chunk at a time), frames taken
back to back with no pacer.

Set-up writes the series (STL shapes, pose VTK files, manifest, config)
under ``TMPDIR``, commits it as a user's series and takes one whole loop
over the files, which builds every kernel and warms every shape the window
uses.  The window takes frames for its seconds.

The check: the stream's first chunk and up to two chunks of the window,
drawn from the seed, are rendered again by the plain reference
(``reference/``) from the same inputs: the first from the reference's own
empty history, each window chunk from the program's temporal history at
its start (the reference cannot afford to replay the whole stream); every
frame of those chunks is held to the reference's bytes, and the program's
history after each chunk to the reference's.  A chunk that the check
could not capture, or a frame of one that it could not compare, counts in
``unchecked``, whose limit is 0.
"""

from __future__ import annotations

import gc
import inspect
import random
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench.gen import pile as gen
from portbench.reference import core, path, render
from portbench.reference.pile import Pile, apply

KEEP = 2            # window chunks kept for the check (reservoir size)
LOST = 1 << 62      # the chunk index once the frames and chunks part


class Run:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, size=None):
        """``size``: overrides of the configuration for a small rehearsal
        on the CPU (width, height, particles)."""
        self.cfg = dict(cfg, **(size or {}))
        self.mix = mix
        self.seed = int(seed)
        self.render_seed = self.seed % (1 << 20)
        self.device = torch.device(device)
        self.rng = random.Random(self.seed ^ 0x5EED)

    # ---- set-up -----------------------------------------------------------

    def inputs(self):
        """The pile of ``gen.POSE_SEED`` (every seed renders the same
        scene: poses drawn per seed moved the frame rate by 5%), its
        particles listed in an order drawn from the seed; the render seed
        from the seed too."""
        c = self.cfg
        base = gen.pile_poses(c["particles"], gen.ANIM_TIMES, gen.POSE_SEED)
        perm = np.random.default_rng(self.seed).permutation(c["particles"])
        self.poses = [{k: v[perm] for k, v in p.items()} for p in base]
        self.shapes = gen.library_shapes()
        panel = self.mix.get("panel")
        self.panel = None if panel is None else (
            gen.light_corners(panel["z"], panel["half"]),
            [panel["radiance"]] * 3)

    def write_series(self, root: Path) -> Path:
        c = self.cfg
        series, stl_dir = gen.write_time_series(root / "time", self.shapes,
                                                self.poses, gen.ANIM_TIMES)
        extra = dict(integrator=self.mix["integrator"], seed=self.render_seed,
                     spp=c["spp"], denoise=c["denoise"],
                     temporal=c["temporal"], background=c["background"],
                     sampler=c["sampler"])
        if self.panel is not None:
            light = gen.write_light_obj(root / "light.obj",
                                        self.panel[0][0][2],
                                        self.panel[0][2][0])
            extra.update(
                emissives=[{"emission": self.panel[1]}],
                meshes=[{"obj": "anim.ground.obj", "mat-type": "ROUGH",
                         "mat-index": 0},
                        {"obj": str(light), "mat-type": "EMISSIVE",
                         "mat-index": 0}])
        return gen.write_anim_config(root / "anim.json", series, stl_dir,
                                     root / "cache", c["width"], c["height"],
                                     gen.ANIM_FPS, c["max_depth"], **extra)

    def setup(self) -> None:
        from optix_ray_tracer_tpu_torch.io.config import load_config
        from optix_ray_tracer_tpu_torch.models import fused
        from optix_ray_tracer_tpu_torch.models import renderer_time as rt

        self.inputs()
        self._tmp = tempfile.TemporaryDirectory(prefix="portbench_")
        path = self.write_series(Path(self._tmp.name))
        self.fused = fused
        self.real_chunk = fused.fused_chunk
        self.chunk_args = inspect.signature(self.real_chunk)
        fused.fused_chunk = self._chunk
        self.chunks = []         # dicts: start, ks, seeds, t_in, t_out
        self.kept = []           # indices into chunks: the window's sample
        self.dispatched = 0
        self.delivering = -1     # the chunk whose frames arrive now
        self.window_start = None
        self.frames = {}         # stream index -> bytes, for kept chunks
        self.labels = []         # (fi, k) of every delivered frame
        self.n_window_chunks = 0
        data = rt.commit(load_config(str(path)), device=self.device)
        self.n_frames = [max(1, int(d * float(gen.ANIM_FPS)))
                         for d in data.durations]
        self.loop = sum(self.n_frames)
        self.gen = rt.render_frames(data, loop=True, quantize=True)
        self.data = data
        self.delivered = 0
        self.failed = 0
        self.t_last = None
        for _ in range(self.loop):
            self._take()
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _chunk(self, *args, **kw):
        """The fused loop's chunk, recorded with its frames, seeds and
        temporal history in and out (arguments bound by name)."""
        a = self.chunk_args.bind(*args, **kw).arguments
        out = self.real_chunk(*args, **kw)
        ks = [int(k) for k in a["ks"]]
        self.chunks.append(dict(
            start=self.dispatched, ks=ks, seeds=[int(x) for x in a["seeds"]],
            t_in=a.get("tstate"),
            t_out=out[1] if isinstance(out, tuple) and len(out) == 2
            else None))
        self.dispatched += len(ks)
        return out

    def _arrive(self, s: int) -> None:
        """Frame s starts a chunk: the first one is the stream's start; a
        window chunk enters a reservoir sample of KEEP, drawn from the
        seed; the histories of the chunks left out are dropped."""
        n = self.delivering = self.delivering + 1
        if n >= len(self.chunks) or self.chunks[n]["start"] != s:
            self.delivering = LOST       # the check's compare counts it
            return
        drop = [] if n == 0 else [n - 1]
        if self.window_start is not None and s >= self.window_start:
            self.n_window_chunks += 1
            if len(self.kept) < KEEP:
                self.kept.append(n)
            else:
                j = self.rng.randrange(self.n_window_chunks)
                if j < KEEP:
                    drop.append(self.kept[j])
                    self.kept[j] = n
        for m in drop:
            if m != 0 and m not in self.kept:
                r = self.chunks[m]
                r["t_in"] = r["t_out"] = None
                for x in range(r["start"], r["start"] + len(r["ks"])):
                    self.frames.pop(x, None)

    def _take(self):
        """Take the next frame from the stream; returns its arrival time."""
        fi, k, frame = next(self.gen)
        now = time.perf_counter()
        s = self.delivered
        rgba = np.asarray(frame.to_uint8())
        c = self.cfg
        if rgba.shape != (c["height"], c["width"], 4) or rgba.dtype != np.uint8:
            self.failed += 1
        self.labels.append((int(fi), int(k)))
        n = self.delivering
        if n < 0 or (n < len(self.chunks) and s >= self.chunks[n]["start"]
                     + len(self.chunks[n]["ks"])):
            self._arrive(s)
            n = self.delivering
        if n == 0 or n in self.kept:
            self.frames[s] = rgba[..., :3].copy()
        self.delivered += 1
        gap = None if self.t_last is None else now - self.t_last
        self.t_last = now
        return now, gap

    # ---- the window ---------------------------------------------------------

    def _chunk_end(self, s: int) -> int:
        """The stream index one past the end of the chunk holding s."""
        for r in reversed(self.chunks):
            if r["start"] <= s:
                return r["start"] + len(r["ks"])
        return s + 1

    def window(self, seconds: float, max_units: int | None = None) -> dict:
        """Frames back to back from ``seconds`` on the clock's start until
        the end of the first chunk that arrives after them (or holds the
        ``max_units``-th frame): the window is the span to that chunk's
        arrival, so a rate counts whole chunks over the time they took."""
        t0 = time.perf_counter()
        first = self.window_start = self.delivered
        gaps = []
        self.failed = 0
        stop = None
        while True:
            now, gap = self._take()
            gaps.append(gap)
            n = self.delivered - first
            if stop is None and (now > t0 + seconds or (
                    max_units is not None and n >= max_units)):
                stop = self._chunk_end(self.delivered - 1)
            if stop is not None and self.delivered >= stop:
                break
        self.window_end = self.delivered
        n = self.delivered - first
        return dict(attempted=n, failed=self.failed, units=n, frames=n,
                    gaps_s=gaps, window_s=now - t0)

    def release(self) -> None:
        """Free the program's state; keep the sampled chunks' histories."""
        self.gen.close()
        self.fused.fused_chunk = self.real_chunk
        self.gen = self.data = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        self._tmp.cleanup()

    # ---- the check ----------------------------------------------------------

    def checked(self) -> list:
        """The chunks the check renders again: the stream's start and the
        window's sample."""
        return ([0] if self.chunks else []) + sorted(self.kept)

    def required(self) -> int:
        """The chunks the check has to render again: the start and
        ``KEEP`` of the window's, or every window chunk where it had
        fewer (one at least, counted whether captured or not)."""
        return 1 + min(KEEP, max(1, self.n_window_chunks))

    def expected(self, s: int):
        """(file, frame, seed) of stream frame s."""
        j = s % self.loop
        fi = 0
        while j >= self.n_frames[fi]:
            j -= self.n_frames[fi]
            fi += 1
        return fi, j, self.render_seed + s

    def reference(self):
        return Pile(self.poses, [v for v, _ in self.shapes], gen.ANIM_TIMES,
                    gen.ANIM_FPS,
                    gen.GROUND, gen.GROUND_ALBEDO, self.panel, self.device)

    def frame_bytes(self, pile, cam, s, state, dtype):
        """The reference's bytes of stream frame s and its new history."""
        c = self.cfg
        W, H = c["width"], c["height"]
        fi, k, seed = self.expected(s)
        fr = pile.frame(fi, k)
        sh = render.Shading(fr.normals, fr.material, pile.mtype, pile.albedo,
                            torch.zeros_like(pile.mtype, dtype=torch.float32),
                            pile.emission)
        pix, samp, o, d = render.camera_wave(cam, W, H, seed)
        if self.mix["integrator"] == "whitted":
            rad, alb, nrm, t_g, prim = render.whitted(
                fr.groups, sh, o, d, pix, samp, seed, c["background"],
                c["max_depth"], dtype)
        else:
            rad, alb, nrm, t_g, prim = path.path(
                fr.groups, sh, self.lights(pile, fr), o, d, pix, samp, seed,
                c["background"], c["max_depth"], dtype=dtype)
        oc, dc = cam.rays(W, H)
        hit = (t_g < core.INF)[:, None]
        x = torch.where(hit, oc + t_g[:, None] * dc, oc + dc)
        part = torch.where(prim >= 0, fr.particle[torch.clamp(prim, min=0)],
                           torch.full_like(prim, -1))
        p = torch.clamp(part, min=0)
        (rk, sk), (rp, sp) = fr.poses, fr.prev_poses
        x_obj = apply(rk[p].transpose(-1, -2), x - sk[p])
        x_prev = torch.where((part >= 0)[:, None],
                             apply(rp[p], x_obj) + sp[p], x)
        return render.tail(state, rad.reshape(H, W, 3), alb.reshape(H, W, 3),
                           nrm.reshape(H, W, 3), t_g.reshape(H, W),
                           x_prev.reshape(H, W, 3), cam, W, H)

    def lights(self, pile, fr):
        """The panel's two triangles, the scene's last, as area lights."""
        n_tri = fr.normals.shape[0]
        return path.AreaLights.build(
            pile.ex_v[-2:], torch.arange(n_tri - 2, n_tri, device=self.device),
            n_tri, torch.as_tensor(self.panel[1], dtype=torch.float32))

    def compare(self, dtype, against=None) -> dict:
        """The compared numbers: the worst share of a checked frame's
        channels more than 2 LSB from the reference's; the worst share of
        pixels whose history after a checked chunk departs from the
        reference's; the count of frames delivered out of the stream's
        order or with another seed; and the count of chunks the check
        needed and could not capture (fewer than ``required()``, or with no
        history in or out) and of their frames it could not compare.
        ``against``: hold the reference in ``dtype`` to the float32
        reference instead of the program."""
        pile = self.reference()
        c = self.cfg
        cam = core.Camera.look_at(gen.TIME_EYE, gen.camera_target(),
                                  (0.0, 0.0, 1.0), self.device)
        worst_px = worst_hist = 0.0
        schedule = 0
        for s, lab in enumerate(self.labels[:self.window_end]):
            if lab != self.expected(s)[:2]:
                schedule += 1
        done = self.checked()
        unchecked = max(0, self.required() - len(done))
        for n in done:
            r = self.chunks[n]
            if n == 0:
                state = render.empty_history(c["width"], c["height"],
                                             self.device)
            elif isinstance(r["t_in"], dict):
                state = {k: v.clone() for k, v in r["t_in"].items()}
            else:
                unchecked += 1
                continue
            if against is None and not isinstance(r["t_out"], dict):
                unchecked += 1
                continue
            ref_state = state if against is not None else None
            for j, (k, sd) in enumerate(zip(r["ks"], r["seeds"])):
                s = r["start"] + j
                fi, k_exp, seed = self.expected(s)
                schedule += int(k != k_exp) + int(sd != seed)
                got, state = self.frame_bytes(pile, cam, s, state, dtype)
                if against is not None:
                    want, ref_state = self.frame_bytes(pile, cam, s,
                                                       ref_state, torch.float32)
                    prog = want.cpu().numpy()
                else:
                    prog = self.frames.get(s)
                    if prog is None:
                        unchecked += 1
                        continue
                got = got.cpu().numpy().astype(np.int16)
                bad = np.abs(got - prog.astype(np.int16)) > 2
                worst_px = max(worst_px, float(bad.mean()))
            out_state = ref_state if against is not None else r["t_out"]
            a, b = state["irr"], out_state["irr"]
            off = ((a - b).abs() > 1e-3 + 1e-2 * b.abs()).any(-1)
            worst_hist = max(worst_hist, float(off.float().mean()))
        return dict(frame_px_share=worst_px, history_share=worst_hist,
                    schedule=float(schedule), unchecked=float(unchecked))

    def check(self) -> dict:
        return self.compare(torch.float32)

    def control(self) -> dict:
        low = self.compare(torch.float32)
        high = self.compare(torch.bfloat16, against=True)
        return {**{f"program.{k}": v for k, v in low.items()},
                **{f"control.{k}": v for k, v in high.items()}}
