"""Schedules for kernel A's bundle walk (``common`` None) built by hand,
shared by tests/test_torch_bundle.py (the plain twins on the CPU) and
tests/test_torch_cuda.py (the kernel on the card); imports no jax.

:func:`copies_schedule` pairs every tile with every window of ``copies``
identical copies of a ClusterSet's rows, copy after copy: each ray's hits
lie once in every copy at equal t, so its rows are ``copies`` times the
windows long and every hit is a tie across chunk boundaries, which the
earliest copy in the tile's order must win.  Its rays are a wave's first
``n_blocks`` tiles with tile 1 all dead (t_max <= t_min), tile 2 one live
ray, in tile 3 NaN t_min, NaN t_max, NaN origins and t_max == t_min, tile
4 no pair at all, tile 5 the copies in reverse order; then padding pairs;
some sub boxes hold a NaN."""

import torch


def copies_schedule(clusters, o, d, t_min, t_max, w: int, copies: int = 4,
                    n_blocks: int = 6) -> dict:
    """The ``raster_cluster_call`` arguments (but w, any_hit, common) of
    the copies schedule over the rays (o, d, t_min, t_max) in w-ray
    tiles."""
    dev = o.device
    C = clusters.num_clusters
    n = n_blocks * w
    rays = torch.zeros((8, (n_blocks + 1) * w), device=dev)
    rays[0:3, :n] = o[:n].T
    rays[3:6, :n] = d[:n].T
    rays[6, :n] = t_min[:n]
    rays[7, :n] = t_max[:n]
    rays[7, w:2 * w] = 0.0                       # tile 1: all dead
    rays[7, 2 * w:3 * w] = 0.0                   # tile 2: one live ray
    rays[7, 2 * w + 5] = 1e16
    t3 = slice(3 * w, 4 * w)
    rays[6, t3][0::7] = float("nan")
    rays[7, t3][1::7] = float("nan")
    rays[0, t3][2::7] = float("nan")
    rays[7, t3][3::7] = rays[6, t3][3::7]
    windows = torch.arange(copies * C, dtype=torch.int32, device=dev)
    backward = torch.cat([windows[k * C:(k + 1) * C]
                          for k in reversed(range(copies))])
    tiles, ids = [], []
    for b in range(n_blocks):
        if b == 4:
            continue
        tiles.append(torch.full((copies * C,), b, dtype=torch.int32,
                                device=dev))
        ids.append(backward if b == 5 else windows)
    tiles.append(torch.full((7,), n_blocks, dtype=torch.int32, device=dev))
    ids.append(torch.zeros(7, dtype=torch.int32, device=dev))
    sub = torch.cat([clusters.sub_min.reshape(C, 4, 3),
                     clusters.sub_max.reshape(C, 4, 3),
                     torch.zeros((C, 4, 2), device=dev)], 2)
    sub[3::7, 0, 0] = float("nan")               # sub boxes that never fire
    sub[5::11, 2, 4] = float("nan")
    return dict(pair_tiles=torch.cat(tiles), pair_clusters=torch.cat(ids),
                rays_t_ext=rays.contiguous(),
                sub_boxes=sub.repeat(copies, 1, 1).contiguous(),
                woop_t=clusters.woop_t.repeat(copies, 1, 1).contiguous(),
                n_blocks=n_blocks, n_subs=sub.shape[1], granularity=1)


def check_copies(inp: dict, out, w: int, copies: int = 4) -> None:
    """The copies schedule's answers: every hit in the copy its tile meets
    first, none in tiles 1 and 4 (tile 4: t_max, slot -1), one at most in
    tile 2, and the dead rays of tiles 1 to 3 answer t = t_max, slot -1,
    u = v = 0."""
    t, slot, u, v = (x.reshape(-1) for x in out[:4])
    C = inp["woop_t"].shape[0] // copies
    tile = torch.arange(t.numel(), device=t.device) // w
    first = torch.where(tile == 5, copies - 1, 0)
    hit = slot >= 0
    assert bool(hit.any())
    copy = slot.long() // 256 // C
    assert torch.equal(copy[hit], first[hit])
    rays = inp["rays_t_ext"][:, :t.numel()]
    dead = ~(rays[7] > rays[6])
    assert int(dead[2 * w:3 * w].sum()) == w - 1
    assert not bool(hit[w:2 * w].any()) and not bool(hit[4 * w:5 * w].any())
    assert int(hit[2 * w:3 * w].sum()) <= 1
    same = (t == rays[7]) | (torch.isnan(t) & torch.isnan(rays[7]))
    assert bool(same[dead].all()) and bool(same[4 * w:5 * w].all())
    assert not bool(hit[dead].any())
    assert not bool((u[dead] != 0).any()) and not bool((v[dead] != 0).any())


def same_bits(a, b) -> bool:
    """Equal tensors, any NaN equal to any NaN."""
    if a.dtype.is_floating_point:
        return a.shape == b.shape and bool(
            ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)
