"""Train the learned denoiser (``render/neural_denoise.KPCN``) on the
renderer's own noisy / clean pairs (port of
``optix_ray_tracer_tpu/render/train_denoiser.py``).

Scenes: the BASELINE configs (``models/benchmarks.py``) and randomised
procedural scenes, plus frame 0 of the reference particle series when
its directory is given (``--reference DIR``: the reference's
``config.json``, ``particle-short.vtk.series`` and ``shape/separated/``)
and present.  For each scene and a few orbit cameras a 1-spp frame
(noisy, with albedo and normal guides) and a high-spp frame (the clean
target) are rendered; the CNN is then fitted on random augmented crops
under ``torch.autograd``: Adam on a cosine decay to 0.02 lr (optax's
``cosine_decay_schedule(lr, steps, alpha=0.02)`` step for step), L1 on
Reinhard-tonemapped, albedo-demodulated radiance.  The crops and batch
indices come from ``numpy.random.default_rng(seed)`` as in the JAX
package, so both draw the same ones.

Usage:
    python -m optix_ray_tracer_tpu_torch.render.train_denoiser \\
        [--steps 3000] [--size 192] [--views 4] [--clean-spp 256] \\
        [--data dataset.npz] [--out denoiser_weights.npz] [--cpu] \\
        [--reference DIR]

It runs on the card unless ``--cpu``.  ``--out`` defaults to
``denoiser_weights.npz`` in the working directory; the committed weights
(``render/denoiser_data/weights.npz``) change only when ``--out`` names
them.  The held-out scenes (config 3 and two procedural scenes) are
never trained on; the run ends with raw / a-trous / neural PSNR on them.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.utils.tensors import resolve_device

#: the default --out: the working directory, never the committed weights
DEFAULT_OUT = "denoiser_weights.npz"


def _orbit(camera, angle: float, lift: float = 0.0):
    """The camera orbited about its target by ``angle`` radians; |target -
    center| (which sets the field of view) is kept up to the small
    ``lift`` term."""
    from optix_ray_tracer_tpu_torch.scene.camera import Camera

    c = camera.center.cpu().numpy().astype(np.float64)
    t = camera.target.cpu().numpy().astype(np.float64)
    off = c - t
    ca, sa = np.cos(angle), np.sin(angle)
    off = np.asarray([off[0] * ca - off[1] * sa,
                      off[0] * sa + off[1] * ca,
                      off[2] + lift * np.linalg.norm(off)])
    return Camera.look_at(tuple(t + off), tuple(t), (0.0, 0.0, 1.0),
                          device=camera.center.device)


def _render_pair(cfg, camera, size, seed, clean_spp):
    """(noisy 1 spp, albedo, normal, clean) of one view: linear (H, W, 3)
    float32 numpy arrays."""
    from optix_ray_tracer_tpu_torch.models import common as mcommon
    from optix_ray_tracer_tpu_torch.render import pathtracer, wavefront

    scene, mats = cfg["scene"], cfg["materials"]
    inter = mcommon.choose_intersector(scene)
    kw = dict(width=size, height=size, intersector=inter,
              background=cfg.get("background", (0.7, 0.8, 0.9)),
              max_depth=cfg.get("max_depth", 5), env=cfg.get("env"))
    if cfg.get("integrator") == "path":
        def rend(spp, sd, samples_per_wave=None):
            return pathtracer.render_path(
                scene, mats, cfg.get("lights"), camera, spp=spp, seed=sd,
                textures=cfg.get("textures"), clamp=8.0,
                samples_per_wave=samples_per_wave, **kw)
    else:
        def rend(spp, sd, samples_per_wave=None):
            return wavefront.render(scene, mats, camera, spp=spp, seed=sd,
                                    samples_per_wave=samples_per_wave, **kw)
    noisy, alb, nrm = rend(1, seed)
    # the clean target in chunks of at most 64 spp with disjoint seeds,
    # each chunk's samples merged into one wave (the streams are keyed by
    # (pixel, sample, bounce), so merging changes no sample; it divides
    # the launches of a launch-bound frame by the chunk)
    chunk = min(clean_spp, 64)
    n_chunks = max(-(-clean_spp // chunk), 1)
    acc = None
    for c in range(n_chunks):
        img = rend(chunk, seed + 7919 + c * 65_537,
                   samples_per_wave=chunk)[0].cpu().numpy()
        img = img.astype(np.float64)
        acc = img if acc is None else acc + img
    clean = (acc / n_chunks).astype(np.float32)
    return tuple(x.cpu().numpy() for x in (noisy, alb, nrm)) + (clean,)


#: held-out scene order (build_dataset and main's per-scene table)
HELDOUT_NAMES = ("config3", "proc_h0", "proc_h1")


def _procedural_cfg(seed: int, device=None) -> dict:
    """One randomised training scene, drawn as the JAX package draws it:
    1-3 tessellated blobs (3k-40k triangles, smooth or faceted normals)
    and 0-3 spheres over a ground sphere; random rough, metal and glass
    materials and sometimes an emissive panel; a flat background, a
    gradient sky or a sun and sky; whitted or path."""
    from optix_ray_tracer_tpu_torch.io.meshgen import (
        quad, sphere_with_n_triangles,
    )
    from optix_ray_tracer_tpu_torch.render.envmap import gradient_sky
    from optix_ray_tracer_tpu_torch.scene.camera import Camera
    from optix_ray_tracer_tpu_torch.scene.geometry import (
        Scene, Spheres, Triangles, face_normals_as_vertex_normals,
    )
    from optix_ray_tracer_tpu_torch.scene.lights import collect_area_lights
    from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    mb = MaterialBuilder()

    def rand_mat():
        r = rng.random()
        if r < 0.55:
            return mb.add_rough(tuple(rng.uniform(0.15, 0.85, 3)))
        if r < 0.85:
            return mb.add_metal(tuple(rng.uniform(0.6, 0.95, 3)),
                                fuzz=float(rng.uniform(0.0, 0.35)))
        return mb.add_dielectric(float(rng.uniform(1.3, 1.8)))

    ground = mb.add_rough(tuple(rng.uniform(0.3, 0.8, 3)))
    spheres = [((0.0, 0.0, -1000.5), 1000.0, ground)]
    vs, ns, ms = [], [], []
    for _ in range(rng.integers(1, 4)):          # tessellated blobs
        c = (float(rng.uniform(-1.5, 1.5)), float(rng.uniform(-1.5, 1.5)),
             float(rng.uniform(-0.2, 0.8)))
        rad = float(rng.uniform(0.3, 0.8))
        v, n = sphere_with_n_triangles(int(rng.integers(3_000, 40_000)),
                                       c, rad)
        m = rand_mat()
        vs.append(v)
        ns.append(n if rng.random() < 0.5 else None)   # smooth or faceted
        ms.append(np.full(len(v), m, np.int32))
    for _ in range(rng.integers(0, 4)):          # analytic spheres
        spheres.append(((float(rng.uniform(-2, 2)),
                         float(rng.uniform(-2, 2)),
                         float(rng.uniform(-0.1, 1.0))),
                        float(rng.uniform(0.2, 0.6)), rand_mat()))

    integrator = "path" if rng.random() < 0.5 else "whitted"
    if integrator == "path" and rng.random() < 0.6:
        # an emissive panel overhead: the area light of the NEE path
        e = mb.add_emissive(tuple(rng.uniform(4.0, 16.0, 3)))
        cx, cy = rng.uniform(-1, 1, 2)
        s = float(rng.uniform(0.4, 1.2))
        v, n = quad([cx - s, cy - s, 2.5], [cx + s, cy - s, 2.5],
                    [cx + s, cy + s, 2.5], [cx - s, cy + s, 2.5])
        vs.append(v)
        ns.append(n)
        ms.append(np.full(len(v), e, np.int32))

    nrm = [face_normals_as_vertex_normals(torch.as_tensor(
               np.asarray(v, np.float32))).numpy() if n is None else n
           for v, n in zip(vs, ns)]
    tris = Triangles.from_arrays(np.concatenate(vs), np.concatenate(nrm),
                                 np.concatenate(ms), device=dev)
    scene = Scene(spheres=Spheres.from_list(spheres, dev), triangles=tris)
    materials = mb.build(dev)

    env = None
    bg = tuple(rng.uniform(0.0, 1.0, 3))
    if rng.random() < 0.4:
        sun = None
        if rng.random() < 0.6:
            sd = rng.normal(size=3)
            sd[2] = abs(sd[2]) + 0.5
            sun = tuple(sd / np.linalg.norm(sd))
        env = gradient_sky(zenith=tuple(rng.uniform(0.2, 0.7, 3)),
                           horizon=tuple(rng.uniform(0.6, 1.0, 3)),
                           sun_dir=sun, device=dev)
        bg = (0.0, 0.0, 0.0)

    az = rng.uniform(0, 2 * np.pi)
    dist = rng.uniform(3.5, 6.0)
    cam = Camera.look_at(
        (dist * np.cos(az), dist * np.sin(az),
         float(rng.uniform(0.3, 1.5))), (0.0, 0.0, 0.2), (0.0, 0.0, 1.0),
        device=dev)
    lights = (collect_area_lights(scene, materials)
              if integrator == "path" else None)
    return dict(scene=scene, materials=materials, camera=cam,
                lights=lights, integrator=integrator, background=bg,
                max_depth=5, env=env)


def _reference_scene(ref_dir: str | None, device) -> dict | None:
    """Frame 0 of the reference particle series in ``ref_dir`` as a
    training scene, or None when no such directory is given."""
    if not ref_dir or not os.path.isdir(ref_dir):
        return None
    import json

    from optix_ray_tracer_tpu_torch.io.config import parse_config_dict
    from optix_ray_tracer_tpu_torch.models import common as mcommon
    from optix_ray_tracer_tpu_torch.models import renderer_time

    with open(os.path.join(ref_dir, "config.json")) as f:
        raw = json.load(f)
    raw["series-name"] = "particle-short.vtk.series"
    raw["series-path"] = ref_dir
    raw["stl-path"] = os.path.join(ref_dir, "shape", "separated", "")
    rcfg = parse_config_dict(raw, base_dir=ref_dir)
    data = renderer_time.commit(rcfg, device=device)
    n_frames = mcommon.frame_count_for_file(
        data.durations[0], rcfg.loop_data.fps,
        rcfg.loop_data.render_speed_ratio)
    scene = renderer_time.frame_scene(data, 0, 0, max(n_frames, 1))
    return dict(scene=scene, materials=data.materials, camera=data.camera,
                integrator="whitted", background=rcfg.background,
                max_depth=rcfg.max_depth, env=data.env)


def build_dataset(size: int = 192, views: int = 4, clean_spp: int = 256,
                  reference_dir: str | None = None, verbose: bool = True,
                  procedural: int = 10, device=None):
    """Render (noisy, albedo, normal, clean) tuples on ``device`` (None:
    the card).  Returns (train_imgs, heldout_imgs); config 3 and two
    procedural scenes of a disjoint seed range are held out entirely.
    ``reference_dir``: the reference dataset, added when present."""
    from optix_ray_tracer_tpu_torch.models import benchmarks as B

    dev = resolve_device(device)
    scenes = [("config1", B.config1_sphere_ground(dev)),
              ("config2", B.config2_whitted_spheres(dev)),
              ("config4", B.config4_cornell(dev)),
              ("config5", B.config5_sponza_class(n_cols=4, device=dev))]
    for k in range(procedural):
        scenes.append((f"proc{k}", _procedural_cfg(1000 + k, dev)))
    heldout_scenes = list(zip(
        HELDOUT_NAMES, (B.config3_mesh_diffuse(20_000, device=dev),
                        _procedural_cfg(9000, dev),
                        _procedural_cfg(9001, dev))))
    ref = _reference_scene(reference_dir, dev)
    if ref is not None:
        scenes.append(("reference", ref))

    def render_set(slist):
        out = []
        for name, cfg in slist:
            cam0 = cfg["camera"]
            for v in range(views):
                cam = cam0 if v == 0 else _orbit(
                    cam0, angle=0.45 * v, lift=0.08 * (v - views / 2))
                cspp = (clean_spp if cfg.get("integrator") != "path"
                        else max(clean_spp, 256))
                t0 = time.time()
                out.append(_render_pair(cfg, cam, size, seed=101 * v + 13,
                                        clean_spp=cspp))
                if verbose:
                    print(f"  {name} view {v}: {time.time() - t0:.1f}s")
        return out

    return render_set(scenes), render_set(heldout_scenes)


def _crops(imgs, n_per_img: int, crop: int, rng):
    """Random augmented crops -> stacked arrays (N, crop, crop, 3) x4."""
    outs = [[], [], [], []]
    for noisy, alb, nrm, clean in imgs:
        H, W = noisy.shape[:2]
        for _ in range(n_per_img):
            y = rng.integers(0, H - crop + 1)
            x = rng.integers(0, W - crop + 1)
            k = rng.integers(0, 4)
            fl = rng.integers(0, 2)
            for o, im in zip(outs, (noisy, alb, nrm, clean)):
                c = im[y:y + crop, x:x + crop]
                c = np.rot90(c, k)
                if fl:
                    c = c[:, ::-1]
                o.append(np.ascontiguousarray(c))
    return [np.stack(o) for o in outs]


def cosine_lr(lr: float, steps: int, step: int, alpha: float = 0.02):
    """``optax.cosine_decay_schedule(lr, steps, alpha)`` at ``step``."""
    t = min(step, steps) / steps
    return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t))
                 + alpha)


def loss_fn(model, no, al, nr, cl):
    """L1 on Reinhard-tonemapped radiance of the filtered demodulated
    input (bounded, so the HDR outliers of path-traced crops cannot own
    the gradient)."""
    from optix_ray_tracer_tpu_torch.render import neural_denoise as nd

    safe = nd.demod_albedo(al)
    out = nd.apply(model, no / safe, al, nr) * safe

    def tone(x):
        return x / (1.0 + torch.abs(x))

    return torch.abs(tone(out) - tone(cl)).mean()


def make_optimizer(model, lr: float):
    """Adam with optax's constants (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def train(train_imgs, steps: int = 3000, batch: int = 16, crop: int = 64,
          lr: float = 2e-3, seed: int = 0, verbose: bool = True,
          device=None):
    """Fit a KPCN from ``neural_denoise.init_params(seed)`` on crops of
    ``train_imgs``; returns the trained module.  The crop set lives on
    ``device`` (None: the card); each step sends only its (batch,) index
    vector."""
    from optix_ray_tracer_tpu_torch.render import neural_denoise as nd

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    crops = _crops(train_imgs, n_per_img=24, crop=crop, rng=rng)
    n = len(crops[0])
    if verbose:
        print(f"dataset: {n} crops of {crop}x{crop}")
    data = [torch.as_tensor(a, device=dev) for a in crops]
    model = nd.KPCN.from_arrays(nd.init_params(seed), dev).train()
    opt = make_optimizer(model, lr)

    t0 = time.time()
    for i in range(steps):
        idx = torch.as_tensor(rng.integers(0, n, batch), device=dev)
        for group in opt.param_groups:
            group["lr"] = cosine_lr(lr, steps, i)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, *(a.index_select(0, idx) for a in data))
        loss.backward()
        opt.step()
        if verbose and (i % 200 == 0 or i == steps - 1):
            print(f"step {i}: loss {loss.item():.4f} "
                  f"({time.time() - t0:.0f}s)")
    return model.eval()


def evaluate(params, imgs, label: str = "held-out", verbose: bool = True,
             device=None):
    """(raw, a-trous, neural) mean PSNR in sRGB over full images."""
    from optix_ray_tracer_tpu_torch.render import denoise as dn
    from optix_ray_tracer_tpu_torch.render import neural_denoise as nd
    from optix_ray_tracer_tpu_torch.utils.color import linear_to_srgb

    dev = (next(params.parameters()).device
           if isinstance(params, nd.KPCN) else resolve_device(device))

    def psnr(a, b):
        a = linear_to_srgb(torch.as_tensor(a, device=dev)).cpu().numpy()
        b = linear_to_srgb(torch.as_tensor(b, device=dev)).cpu().numpy()
        mse = float(np.mean((a - b) ** 2))
        return 10.0 * np.log10(1.0 / max(mse, 1e-12))

    raws, ats, nns = [], [], []
    for noisy, alb, nrm, clean in imgs:
        x = [torch.as_tensor(a, device=dev) for a in (noisy, alb, nrm)]
        raws.append(psnr(noisy, clean))
        ats.append(psnr(dn.denoise(*x), clean))
        nns.append(psnr(nd.denoise_neural(*x, params), clean))
    out = (float(np.mean(raws)), float(np.mean(ats)), float(np.mean(nns)))
    if verbose:
        print(f"{label}: raw {out[0]:.2f} dB | a-trous {out[1]:.2f} dB | "
              f"neural {out[2]:.2f} dB")
    return out


def _save_dataset(path, train_imgs, heldout):
    arrs = {}
    for tag, imgs in (("train", train_imgs), ("held", heldout)):
        for j, name in enumerate(("noisy", "alb", "nrm", "clean")):
            arrs[f"{tag}_{name}"] = np.stack([im[j] for im in imgs])
    np.savez_compressed(path, **arrs)


def _load_dataset(path):
    with np.load(path) as z:
        out = []
        for tag in ("train", "held"):
            stacks = [z[f"{tag}_{n}"] for n in ("noisy", "alb", "nrm",
                                                "clean")]
            out.append(list(zip(*[list(s) for s in stacks])))
    return out[0], out[1]


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="optix_ray_tracer_tpu_torch.render.train_denoiser")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--size", type=int, default=192)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--clean-spp", type=int, default=256)
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="weights file to write (default: %(default)s in "
                         "the working directory)")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the CUDA device)")
    ap.add_argument("--reference", default=None, metavar="DIR",
                    help="the reference dataset's directory: its particle "
                         "series joins the training set when present")
    ap.add_argument("--data", default=None,
                    help="npz cache of the rendered dataset: loaded if "
                         "present, written after rendering otherwise")
    args = ap.parse_args(argv)

    from optix_ray_tracer_tpu_torch.render import neural_denoise as nd

    dev = resolve_device("cpu" if args.cpu else None)
    if args.data and os.path.exists(args.data):
        print(f"loading dataset {args.data} ...")
        train_imgs, heldout = _load_dataset(args.data)
    else:
        print("rendering training set ...")
        train_imgs, heldout = build_dataset(
            size=args.size, views=args.views, clean_spp=args.clean_spp,
            reference_dir=args.reference, device=dev)
        if args.data:
            _save_dataset(args.data, train_imgs, heldout)
            print(f"saved dataset {args.data}")
    model = train(train_imgs, steps=args.steps, device=dev)
    evaluate(model, train_imgs[:4], label="train[0:4]")
    evaluate(model, heldout)
    # the held-out table per scene: `views` consecutive images each
    if len(heldout) % len(HELDOUT_NAMES) == 0:
        v = len(heldout) // len(HELDOUT_NAMES)
        for i, nm in enumerate(HELDOUT_NAMES):
            evaluate(model, heldout[i * v:(i + 1) * v],
                     label=f"held-out {nm}")
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    nd.save_params(model, args.out)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
