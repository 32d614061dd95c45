"""SLIC superpixels on a fixed seed grid, at static shapes, over a batch.

Counterpart of ``gcn_grabcut_tpu/ops/slic.py`` (which the JAX package
vmaps over a batch): cluster seeds live on a ``gh x gw`` grid (K = gh·gw
labels, static), each pixel searches the 3x3 grid neighbourhood of its home
cell, a fixed number of k-means iterations run in LABXY space, and
connectivity is repaired by orphan absorption and a min-label component
pass.  Images are (B, H, W, 3), labels (B, H, W).

The JAX package moves values between pixels and cells with one-hot matmuls
(a TPU workaround for slow gathers); here the same exchange is a gather
(cells -> pixels) and a fixed-order segment sum over ids b·K + label
(pixels -> cells; the same labels in every run on the card, and an image's
chains in a batch are its chains alone).  The sums are the same up to
float32 summation order, so near-tied argmins can flip at a few pixels:
compare labels with the JAX package's by agreement, not bit equality.

The connectivity repair (`repair_connectivity`: `_absorb_orphans`, then
`enforce_connectivity`) is on the card one launch of the hand-written
kernel ``csrc/slic_connectivity.cu``, which decides each image's loops
there (the JAX package's ``lax.while_loop``s); on the CPU it runs the plain
versions, eager loops that test the batch's convergence on the host.  The
two give the same labels.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from .region import segment_sum

_OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
_BIG = 1e9   # sentinel centre for out-of-grid candidates


def grid_shape(h: int, w: int, n_segments: int) -> tuple[int, int]:
    """Seed grid (gh, gw) with gh*gw ≈ n_segments, cells ~square."""
    step = math.sqrt(h * w / max(n_segments, 1))
    return max(1, round(h / step)), max(1, round(w / step))


def slic_num_labels(h: int, w: int, n_segments: int) -> int:
    gh, gw = grid_shape(h, w, n_segments)
    return gh * gw


def _gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian of (B, H, W, C) images, reflect borders."""
    radius = max(1, int(3 * sigma + 0.5))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=img.device)
    k = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    k = k / k.sum()

    def conv_axis(a, dim):
        n = a.shape[dim]
        bchw = a.permute(0, 3, 1, 2)                     # (B, C, H, W)
        pad = (0, 0, radius, radius) if dim == 1 else (radius, radius, 0, 0)
        ap = F.pad(bchw, pad, mode="reflect").permute(0, 2, 3, 1)
        out = torch.zeros_like(a)
        for i in range(2 * radius + 1):
            out = out + k[i] * ap.narrow(dim, i, n)
        return out

    return conv_axis(conv_axis(img, 1), 2)


def slic(lab: torch.Tensor, n_segments: int = 300, compactness: float = 10.0,
         n_iter: int = 10, smooth_sigma: float = 1.0) -> torch.Tensor:
    """Segment each image of `lab` (B, H, W, 3) into K = gh*gw
    superpixels; (B, H, W) int64 labels in [0, K), each label's region
    connected (`slic_labels`, then `repair_connectivity`)."""
    _, H, W, _ = lab.shape
    return repair_connectivity(
        slic_labels(lab, n_segments, compactness, n_iter, smooth_sigma),
        slic_num_labels(H, W, n_segments))


def slic_labels(lab: torch.Tensor, n_segments: int = 300,
                compactness: float = 10.0, n_iter: int = 10,
                smooth_sigma: float = 1.0) -> torch.Tensor:
    """SLIC's iterations on (B, H, W, 3) Lab images: (B, H, W) int64
    labels in [0, K) before the connectivity repair."""
    B, H, W, _ = lab.shape
    dev = lab.device
    gh, gw = grid_shape(H, W, n_segments)
    K = gh * gw
    sy, sx = H / gh, W / gw
    s_avg = math.sqrt(sy * sx)

    lab = lab.float()
    if smooth_sigma > 0:
        lab = _gaussian_blur(lab, smooth_sigma)

    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)

    cy = (torch.arange(gh, dtype=torch.float32, device=dev) + 0.5) * sy
    cx = (torch.arange(gw, dtype=torch.float32, device=dev) + 0.5) * sx
    cyx = torch.stack(torch.meshgrid(cy, cx, indexing="ij"), dim=-1)
    seed_y = cyx[..., 0].long().clamp(0, H - 1)
    seed_x = cyx[..., 1].long().clamp(0, W - 1)
    centers = torch.cat([lab[:, seed_y, seed_x],
                         cyx.expand(B, gh, gw, 2)], dim=-1)  # (B, gh, gw, 5)

    base_cy = (yy[:, 0] / sy).long().clamp(0, gh - 1)          # (H,)
    base_cx = (xx[0, :] / sx).long().clamp(0, gw - 1)          # (W,)
    inv_s2 = (compactness / s_avg) ** 2
    # _OFFSETS' (dy, dx), made on the device: no host copy.
    dys = torch.arange(9, device=dev) // 3 - 1
    dxs = torch.arange(9, device=dev) % 3 - 1

    def shifted_centers(c):
        """(B, gh, gw, 9, 5): candidate centre per cell and offset."""
        cp = F.pad(c.permute(0, 3, 1, 2), (1, 1, 1, 1), value=_BIG)
        return torch.stack([cp[:, :, 1 + dy:1 + dy + gh, 1 + dx:1 + dx + gw]
                            for dy, dx in _OFFSETS], dim=-1
                           ).permute(0, 2, 3, 4, 1)

    def assign(c):
        """Best of 9 candidates per pixel: (B, H, W) labels."""
        cand = shifted_centers(c)[:, base_cy[:, None], base_cx[None, :]]
        d_lab = ((lab[:, :, :, None, :] - cand[..., :3]) ** 2).sum(dim=-1)
        d_xy = ((yy[..., None] - cand[..., 3]) ** 2
                + (xx[..., None] - cand[..., 4]) ** 2)
        choice = torch.argmin(d_lab + d_xy * inv_s2, dim=-1)   # (B, H, W)
        return ((base_cy[:, None] + dys[choice]) * gw
                + base_cx[None, :] + dxs[choice])

    feats = torch.cat([lab, yy.expand(B, H, W)[..., None],
                       xx.expand(B, H, W)[..., None],
                       torch.ones((B, H, W, 1), device=dev)], dim=-1)
    flat_feats = feats.reshape(-1, 6)
    offset = torch.arange(B, device=dev).reshape(B, 1, 1) * K
    for _ in range(n_iter):
        lbl = assign(centers)
        total = segment_sum((lbl + offset).reshape(-1), flat_feats, B * K)
        total = total.reshape(B, gh, gw, 6)
        cnts = total[..., 5]
        means = total[..., :5] / cnts.clamp_min(1.0)[..., None]
        centers = torch.where((cnts > 0)[..., None], means, centers)
    return assign(centers)


def _edge_neighbours(lb: torch.Tensor):
    """(up, down, left, right) neighbours of (B, H, W) with edge
    replication."""
    up = torch.cat([lb[:, :1], lb[:, :-1]], dim=1)
    dn = torch.cat([lb[:, 1:], lb[:, -1:]], dim=1)
    lf = torch.cat([lb[:, :, :1], lb[:, :, :-1]], dim=2)
    rt = torch.cat([lb[:, :, 1:], lb[:, :, -1:]], dim=2)
    return up, dn, lf, rt


def _parity(H: int, W: int, device) -> torch.Tensor:
    yy = torch.arange(H, device=device)[:, None]
    xx = torch.arange(W, device=device)[None, :]
    return (yy + xx) % 2


def absorb_orphans_plain(labels: torch.Tensor, n_sweeps: int = 2
                         ) -> torch.Tensor:
    """The plain version of `_absorb_orphans`: checkerboard half-sweeps of
    the (B, H, W) batch, eager."""
    parity = _parity(*labels.shape[1:], labels.device)

    def half_sweep(lb, phase):
        nbrs = _edge_neighbours(lb)
        same = ((nbrs[0] == lb) | (nbrs[1] == lb) | (nbrs[2] == lb)
                | (nbrs[3] == lb))
        counts = [sum((n == cand).int() for n in nbrs) for cand in nbrs]
        best, best_c = nbrs[0], counts[0]
        for cand, c in zip(nbrs[1:], counts[1:]):
            take = c > best_c
            best = torch.where(take, cand, best)
            best_c = torch.where(take, c, best_c)
        move = ~same & (parity == phase)
        return torch.where(move, best, lb)

    for _ in range(n_sweeps):
        labels = half_sweep(half_sweep(labels, 0), 1)
    return labels


def _fill_neighbours(a: torch.Tensor, fill):
    """(up, down, left, right) neighbours of (B, H, W), out-of-image
    filled."""
    row = torch.full_like(a[:, :1], fill)
    col = torch.full_like(a[:, :, :1], fill)
    return (torch.cat([row, a[:, :-1]], dim=1),
            torch.cat([a[:, 1:], row], dim=1),
            torch.cat([col, a[:, :, :-1]], dim=2),
            torch.cat([a[:, :, 1:], col], dim=2))


def enforce_connectivity_plain(labels: torch.Tensor, k: int,
                               max_sweeps: int = 64) -> torch.Tensor:
    """The plain version of `enforce_connectivity` on (B, H, W): each loop
    runs until a block changes no image, or `max_sweeps` blocks.  An image
    whose block changed nothing is at its fixpoint, where further blocks
    change nothing: its labels are those of its own loops (JAX's vmapped
    while loops)."""
    B, H, W = labels.shape
    hw = H * W
    dev = labels.device
    idx = torch.arange(hw, device=dev).reshape(1, H, W).expand(B, H, W)
    nb_l = _fill_neighbours(labels, -1)
    same = [n == labels for n in nb_l]
    big = torch.full_like(idx, hw)

    comp = idx
    blocks = 0
    for blocks in range(1, max_sweeps + 1):
        new = comp
        for _ in range(4):
            step = new
            for nb_c, s in zip(_fill_neighbours(new, hw), same):
                step = torch.minimum(step, torch.where(s, nb_c, big))
            new = step
        changed = bool((new < comp).any())
        comp = new
        if not changed:
            break

    # Component and label ids offset per image: b·hw + comp, b·k + label.
    comp_id = (comp + torch.arange(B, device=dev).reshape(B, 1, 1) * hw
               ).reshape(-1)
    sizes = torch.zeros(B * hw, dtype=torch.float32, device=dev).index_add_(
        0, comp_id, torch.ones(B * hw, dtype=torch.float32, device=dev))
    comp_size = sizes[comp_id].reshape(B, H, W)
    # (size, -comp) in float32, as the JAX package computes it: ties and
    # float32 rounding resolve identically.
    score = comp_size * hw - comp.float()
    label_id = (labels + torch.arange(B, device=dev).reshape(B, 1, 1) * k
                ).reshape(-1)
    label_best = torch.full((B * k,), float("-inf"), device=dev
                            ).scatter_reduce(0, label_id, score.reshape(-1),
                                             reduce="amax", include_self=True)
    minor = score < label_best[label_id].reshape(B, H, W)

    parity = _parity(H, W, dev)
    rounds = 0
    for rounds in range(1, max_sweeps + 1):
        new_lab, new_minor = labels, minor
        for phase in (0, 1, 0, 1):
            cand_l = _fill_neighbours(new_lab, -1)
            cand_m = _fill_neighbours(new_minor, True)
            take = torch.full_like(new_lab, -1)
            for nl, nm in zip(cand_l, cand_m):
                ok = ~nm & (nl >= 0)
                take = torch.where((take < 0) & ok, nl, take)
            move = new_minor & (take >= 0) & (parity == phase)
            new_lab = torch.where(move, take, new_lab)
            new_minor = new_minor & ~move
        changed = bool((new_minor != minor).any())
        labels, minor = new_lab, new_minor
        if not changed:
            break
    enforce_connectivity_plain.last_loops = {"blocks": blocks,
                                             "rounds": rounds}
    return labels


#: The blocks and rounds the last call ran (the kernel's `kernel_loops`).
enforce_connectivity_plain.last_loops = None


# The kernel's decomposition (csrc/slic_connectivity.cu), modelled on the
# CPU with the plain version's own steps, for the tests: the kernel cannot
# run here.  TILE is the kernel's tile; the models take any.

TILE = 32


def _tiles(H: int, W: int, tile: int):
    """(ty, tx, y0, x0) of every tile of an H x W image."""
    return [(ty, tx, ty * tile, tx * tile)
            for ty in range(-(-H // tile)) for tx in range(-(-W // tile))]


def orphan_tiles(labels: torch.Tensor, n_sweeps: int, tile: int = TILE,
                 halo: int | None = None) -> torch.Tensor:
    """`absorb_orphans_plain(labels, n_sweeps)` as the kernel's one tile
    pass: each tile's 2 n_sweeps half-sweeps run on a window `halo`
    (default 2 n_sweeps) pixels wider, cut at the image's border (where
    the plain version replicates edges), and its interior is pasted back.
    A window's own edge inside the image is wrong by one more pixel each
    half-sweep, so a halo of 2 n_sweeps is exact and one less is not."""
    halo = 2 * n_sweeps if halo is None else halo
    _, H, W = labels.shape
    out = labels.clone()
    for _, _, y0, x0 in _tiles(H, W, tile):
        ya, xa = max(y0 - halo, 0), max(x0 - halo, 0)
        if (ya + xa) % 2:          # the plain version's parity is global
            if ya > 0:
                ya -= 1
            else:
                xa -= 1
        yb, xb = min(y0 + tile + halo, H), min(x0 + tile + halo, W)
        win = absorb_orphans_plain(labels[:, ya:yb, xa:xb], n_sweeps)
        out[:, y0:y0 + tile, x0:x0 + tile] = win[:, y0 - ya:y0 - ya + tile,
                                                 x0 - xa:x0 - xa + tile]
    return out


def same_label(labels: torch.Tensor) -> list:
    """The same-label relation the kernel keeps as 4 bits a pixel: for
    (up, down, left, right), whether that neighbour is in the image and
    has the pixel's label."""
    return [n == labels for n in _fill_neighbours(labels, -1)]


def component_step(comp: torch.Tensor, same: list, hw: int) -> torch.Tensor:
    """One Jacobi step of the components, the plain version's: each pixel
    takes the least of its component and its same-label neighbours'."""
    step = comp
    for nb_c, s in zip(_fill_neighbours(comp, hw), same):
        step = torch.minimum(step, torch.where(s, nb_c, hw))
    return step


def super_block_tiled(comp: torch.Tensor, same: list, steps: int, hw: int,
                      tile: int = TILE, halo: int | None = None
                      ) -> torch.Tensor:
    """`steps` Jacobi steps of the whole lattice done tile by tile, each on
    a window `halo` (default `steps`) pixels wider, whose edge inside the
    image reads nothing beyond it: exact with a halo of `steps`."""
    halo = steps if halo is None else halo
    _, H, W = comp.shape
    out = comp.clone()
    for _, _, y0, x0 in _tiles(H, W, tile):
        ya, xa = max(y0 - halo, 0), max(x0 - halo, 0)
        win = (slice(None), slice(ya, y0 + tile + halo),
               slice(xa, x0 + tile + halo))
        c = comp[win]
        s = [r[win] for r in same]
        for _ in range(steps):
            c = component_step(c, s, hw)
        out[:, y0:y0 + tile, x0:x0 + tile] = c[:, y0 - ya:y0 - ya + tile,
                                               x0 - xa:x0 - xa + tile]
    return out


def plain_blocks(last_change, max_sweeps: int):
    """The plain version's component blocks of 4 steps, recovered from the
    last step D at which the image changed (0: none): it runs the blocks
    up to the one holding step D and one more, which changes nothing,
    unless max_sweeps stops it first."""
    return min(max_sweeps, (int(last_change) + 3) // 4 + 1)


def components_tiled(labels: torch.Tensor, max_sweeps: int, steps: int,
                     tile: int = TILE) -> tuple:
    """The kernel's components: super-blocks of `steps` Jacobi steps (a
    multiple of 4), each tile on a window `steps` wider, and a tile skipped
    when no tile within `steps` of it changed in the last step of the
    super-block before (the skip lemma: a pixel that changes at step t + 1
    has a neighbour that changed at step t, so nothing in it can change).
    The last super-block stops at 4 max_sweeps steps, the plain version's
    cap.  Returns (comp, blocks per image as the plain version counts
    them, tiles run, tiles skipped)."""
    B, H, W = labels.shape
    hw = H * W
    same = same_label(labels)
    comp = torch.arange(hw).reshape(1, H, W).expand(B, H, W).clone()
    ty_n, tx_n = -(-H // tile), -(-W // tile)
    reach = -(-steps // tile)                  # tiles within `steps`
    changed = torch.ones((B, ty_n, tx_n), dtype=torch.bool)
    last = [0] * B
    run = skipped = done = 0
    while done < 4 * max_sweeps and bool(changed.any()):
        n = min(steps, 4 * max_sweeps - done)
        new, now = comp.clone(), torch.zeros_like(changed)
        for b in range(B):
            for ty, tx, y0, x0 in _tiles(H, W, tile):
                if not bool(changed[b, max(ty - reach, 0):ty + reach + 1,
                                    max(tx - reach, 0):tx + reach + 1
                                    ].any()):
                    skipped += 1
                    continue
                run += 1
                ya, xa = max(y0 - n, 0), max(x0 - n, 0)
                win = (slice(b, b + 1), slice(ya, y0 + tile + n),
                       slice(xa, x0 + tile + n))
                inner = (slice(None), slice(y0 - ya, y0 - ya + tile),
                         slice(x0 - xa, x0 - xa + tile))
                c, s = comp[win], [r[win] for r in same]
                for t in range(1, n + 1):
                    nc = component_step(c, s, hw)
                    if bool((nc[inner] < c[inner]).any()):
                        last[b] = max(last[b], done + t)
                        now[b, ty, tx] = t == n
                    c = nc
                new[b, y0:y0 + tile, x0:x0 + tile] = c[inner][0]
        comp, changed = new, now
        done += n
    return comp, [plain_blocks(d, max_sweeps) for d in last], run, skipped


def minor_pixels(labels: torch.Tensor, comp: torch.Tensor, k: int
                 ) -> torch.Tensor:
    """The pixels of each label outside its best component (score size H W
    - comp in float32, as the plain version): the kernel's minor flags."""
    B, H, W = labels.shape
    hw = H * W
    off = torch.arange(B).reshape(B, 1, 1)
    comp_id = (comp + off * hw).reshape(-1)
    sizes = torch.zeros(B * hw).index_add_(0, comp_id, torch.ones(B * hw))
    score = sizes[comp_id].reshape(B, H, W) * hw - comp.float()
    label_id = (labels + off * k).reshape(-1)
    best = torch.full((B * k,), float("-inf")).scatter_reduce(
        0, label_id, score.reshape(-1), reduce="amax", include_self=True)
    return score < best[label_id].reshape(B, H, W)


def absorb_listed(labels: torch.Tensor, minor: torch.Tensor,
                  order, max_sweeps: int) -> tuple:
    """Absorption over the minor pixels only, one at a time in `order`
    (flat indices into (B, H, W)), in place: rounds of phases of parity 0,
    1, 0, 1, a minor pixel of the phase's parity taking the label of its
    first neighbour (up, down, left, right; in the image) that is not
    minor.  A phase writes one parity and reads the other, so the order
    within it does not matter: the kernel's threads take a window's pixels
    in place in any order.  Each image stops after a round that moved none
    of its pixels.  Returns (labels, the rounds the batch ran)."""
    B, H, W = labels.shape
    lab, mnr = labels.numpy().copy(), minor.numpy().copy()
    entries = [(int(p) // (H * W), (int(p) // W) % H, int(p) % W)
               for p in order if mnr.reshape(-1)[int(p)]]
    running = [True] * B
    rounds = 0
    while rounds < max_sweeps and any(running):
        moved = [False] * B
        for phase in (0, 1, 0, 1):
            for b, y, x in entries:
                if not running[b] or (y + x) % 2 != phase or not mnr[b, y, x]:
                    continue
                for qy, qx in ((y - 1, x), (y + 1, x), (y, x - 1),
                               (y, x + 1)):
                    if 0 <= qy < H and 0 <= qx < W and not mnr[b, qy, qx]:
                        lab[b, y, x] = lab[b, qy, qx]
                        mnr[b, y, x] = False
                        moved[b] = True
                        break
        running = [r and m for r, m in zip(running, moved)]
        rounds += 1
    return torch.from_numpy(lab), rounds


def _absorb_phase(lab: torch.Tensor, minor: torch.Tensor,
                  parity: torch.Tensor, phase: int) -> tuple:
    """One absorption phase, the plain version's: a minor pixel of the
    phase's parity takes the label of its first neighbour (up, down, left,
    right; in the image) that is not minor."""
    take = torch.full_like(lab, -1)
    for nl, nm in zip(_fill_neighbours(lab, -1), _fill_neighbours(minor,
                                                                   True)):
        take = torch.where((take < 0) & ~nm & (nl >= 0), nl, take)
    move = minor & (take >= 0) & (parity == phase)
    return torch.where(move, take, lab), minor & ~move


def absorb_tiled(labels: torch.Tensor, minor: torch.Tensor, max_sweeps: int,
                 rounds: int = 2, tile: int = TILE) -> tuple:
    """The kernel's absorption: passes of `rounds` rounds of 4 phases,
    every tile on a window as many pixels wider as the pass has phases (a
    phase reads only a pixel's neighbours), and a tile skipped when no
    tile beside it moved a pixel in the last phase of the pass before (a
    pixel that moves in phase t >= 2 has a neighbour that moved in phase t
    - 1).  The last pass stops at max_sweeps rounds; each image's rounds
    are recovered from the last round R it moved in: the plain version
    runs one more, which moves nothing, so min(max_sweeps, R + 2).
    Returns (labels, the rounds the batch ran, tiles run, tiles
    skipped)."""
    B, H, W = labels.shape
    lab, mnr = labels.clone(), minor.clone()
    ty_n, tx_n = -(-H // tile), -(-W // tile)
    moved = torch.ones((B, ty_n, tx_n), dtype=torch.bool)
    last = [-1] * B
    done = run = skipped = 0
    while done < max_sweeps and bool(moved.any()):
        n = min(rounds, max_sweeps - done)
        halo = 4 * n
        new_lab, new_mnr = lab.clone(), mnr.clone()
        now = torch.zeros_like(moved)
        for b in range(B):
            for ty, tx, y0, x0 in _tiles(H, W, tile):
                if not bool(moved[b, max(ty - 1, 0):ty + 2,
                                  max(tx - 1, 0):tx + 2].any()):
                    skipped += 1
                    continue
                run += 1
                ya, xa = max(y0 - halo, 0), max(x0 - halo, 0)
                win = (slice(b, b + 1), slice(ya, y0 + tile + halo),
                       slice(xa, x0 + tile + halo))
                inner = (slice(None), slice(y0 - ya, y0 - ya + tile),
                         slice(x0 - xa, x0 - xa + tile))
                wl, wm = lab[win], mnr[win]
                hh, ww = wl.shape[1:]
                parity = (_parity(hh, ww, wl.device) + ya + xa) % 2
                for ph in range(4 * n):
                    before = wm[inner]
                    wl, wm = _absorb_phase(wl, wm, parity, ph % 2)
                    if bool((wm[inner] != before).any()):
                        last[b] = max(last[b], done + ph // 4)
                        now[b, ty, tx] = ph == 4 * n - 1
                new_lab[b, y0:y0 + tile, x0:x0 + tile] = wl[inner][0]
                new_mnr[b, y0:y0 + tile, x0:x0 + tile] = wm[inner][0]
        lab, mnr, moved = new_lab, new_mnr, now
        done += n
    return (lab, max(min(max_sweeps, r + 2) for r in last), run,
            skipped)


def repair_tiled(labels: torch.Tensor, k: int, absorb_sweeps: int,
                 max_sweeps: int, steps: int, tile: int = TILE) -> tuple:
    """The kernel's whole repair on the CPU: the orphan tile pass, the
    components by skipped super-blocks, the minor flags and the absorption
    by skipped passes of `steps` / 4 rounds.  Returns (labels, blocks,
    rounds), the counts as the kernel reports them (the batch's most)."""
    labels = orphan_tiles(labels, absorb_sweeps, tile)
    if max_sweeps == 0:
        return labels, 0, 0
    comp, blocks, _, _ = components_tiled(labels, max_sweeps, steps, tile)
    minor = minor_pixels(labels, comp, k)
    out, rounds, _, _ = absorb_tiled(labels, minor, max_sweeps, steps // 4,
                                     tile)
    return out, max(blocks), rounds


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A build of the kernel with the argument types of its C entry points
    set: the repair, its grid, and its grid's empty barriers."""
    lib.slic_connectivity.argtypes = ([ctypes.c_int] * 6
                                      + [ctypes.c_void_p] * 5)
    lib.slic_connectivity_grid.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.slic_connectivity_barriers.argtypes = [ctypes.c_int,
                                               ctypes.c_void_p]
    for fn in (lib.slic_connectivity, lib.slic_connectivity_grid,
               lib.slic_connectivity_barriers):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """The committed kernel's library, built at first use."""
    from ..kernels import load
    return _typed(load("slic_connectivity"))


#: The kernel's tallies, the last words of its ctrl buffer (the stage
#: times only in a build with SLIC_CONNECTIVITY_STATS defined).
TALLY_KEYS = ("tiles_run", "tiles_skipped", "barriers", "super_blocks",
              "steps", "minor", "absorb_tiles_run", "absorb_tiles_skipped",
              "absorb_passes", "orphan_ns", "components_ns", "scores_ns",
              "absorb_ns", "blocks", "rounds")
#: The kernel's grid (`kernel_grid`).
GRID_KEYS = ("blocks", "blocks_per_sm", "registers", "smem_bytes", "tile",
             "super_steps")


def work_bytes(B: int, H: int, W: int, k: int) -> int:
    """The kernel's scratch: with n = B H W pixels and T tiles of TILE x
    TILE, 3 n int32 words (two component planes, the second also the
    absorption's second label plane, and the sizes), B k (the best
    scores), 4 T (the tiles' planes and list stamps, two active lists),
    then 3 n bytes (same-label bits, two planes of minor flags)."""
    n = B * H * W
    tiles = B * -(-H // TILE) * -(-W // TILE)
    return 4 * (3 * n + B * k + 4 * tiles) + 3 * n


def repair_connectivity_cuda(labels: torch.Tensor, k: int,
                             absorb_sweeps: int, max_sweeps: int,
                             lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """Launch csrc/slic_connectivity.cu (or `lib`, another build of it) on
    the current stream: the plain versions'
    `absorb_orphans_plain(labels, absorb_sweeps)` and then, when
    `max_sweeps` > 0, `enforce_connectivity_plain(..., k, max_sweeps)`, for
    (B, H, W) CUDA labels in [0, k); (B, H, W) int64.  One launch, no host
    sync; a refused launch raises."""
    if labels.device.type != "cuda":
        raise ValueError(f"repair_connectivity_cuda takes CUDA labels, got "
                         f"{labels.device}")
    if labels.dim() != 3 or labels.numel() == 0:
        raise ValueError(f"repair_connectivity_cuda takes non-empty (B, H, W)"
                         f" labels, got {tuple(labels.shape)}")
    B, H, W = labels.shape
    if H * W >= 2 ** 24 or k < 1:
        raise ValueError(f"repair_connectivity_cuda takes H W < 2^24 (sizes "
                         f"exact in float32) and k >= 1, got {H} x {W}, k "
                         f"{k}")
    if absorb_sweeps < 0 or max_sweeps < 0:
        raise ValueError(f"absorb_sweeps {absorb_sweeps}, max_sweeps "
                         f"{max_sweeps} (>= 0)")
    if B * H * W >= 2 ** 31:
        raise ValueError(f"repair_connectivity_cuda takes B H W < 2^31, got "
                         f"{B} x {H} x {W}")
    src = labels.to(torch.int32).contiguous()
    out = torch.empty((B, H, W), dtype=torch.int32, device=labels.device)
    work = torch.empty(work_bytes(B, H, W, k), dtype=torch.uint8,
                       device=labels.device)
    # Per image: the last step in which its components changed and the
    # last absorption round (+ 1) in which it moved; the active tiles'
    # lists' lengths and take counters (3 slots each); the tallies.
    ctrl = torch.zeros(2 * B + 6 + len(TALLY_KEYS), dtype=torch.int32,
                       device=labels.device)
    with torch.cuda.device(labels.device):
        stream = torch.cuda.current_stream(labels.device).cuda_stream
        err = (_library() if lib is None else _typed(lib)).slic_connectivity(
            B, H, W, k, absorb_sweeps, max_sweeps, src.data_ptr(),
            out.data_ptr(), work.data_ptr(), ctrl.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"slic_connectivity kernel launch failed: CUDA "
                           f"error {err}")
    repair_connectivity_cuda.kernel_launches += 1
    repair_connectivity_cuda.last_ctrl = ctrl
    return out.long()


#: Launches of the connectivity kernel since the count was last set to 0.
repair_connectivity_cuda.kernel_launches = 0
#: The last launch's ctrl words, left on the card (`kernel_loops` reads
#: them).
repair_connectivity_cuda.last_ctrl = None


def kernel_loops(ctrl: torch.Tensor) -> dict:
    """The component blocks and absorption rounds of a launch, as the plain
    version counts them (host)."""
    c = ctrl.cpu()
    return {"blocks": int(c[-2]), "rounds": int(c[-1])}


def kernel_tally(ctrl: torch.Tensor) -> dict:
    """A launch's tallies (`TALLY_KEYS`, host): its tiles run and skipped
    in the component super-blocks, grid-wide barriers, super-blocks,
    Jacobi steps and minor pixels, the absorption passes' tiles run and
    skipped and its passes, each stage's device ns (with
    SLIC_CONNECTIVITY_STATS, else 0), and `kernel_loops`' counts."""
    c = ctrl.cpu()[-len(TALLY_KEYS):]
    return {key: int(v) for key, v in zip(TALLY_KEYS, c)}


def kernel_grid(lib: ctypes.CDLL | None = None) -> dict:
    """The kernel's grid on the current card (`GRID_KEYS`), or that of
    `lib`, another build of it."""
    info = (ctypes.c_int * len(GRID_KEYS))()
    err = (_library() if lib is None else _typed(lib)).slic_connectivity_grid(
        info)
    if err != 0:
        raise RuntimeError(f"slic_connectivity_grid failed: CUDA error {err}")
    return dict(zip(GRID_KEYS, info))


def barrier_loop_cuda(n: int, device) -> None:
    """`n` empty grid-wide barriers on the kernel's grid: its barrier
    floor, for timing."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().slic_connectivity_barriers(n, stream)
    if err != 0:
        raise RuntimeError(f"slic_connectivity_barriers launch failed: CUDA "
                           f"error {err}")


def repair_connectivity(labels: torch.Tensor, k: int, absorb_sweeps: int = 4,
                        max_sweeps: int = 64) -> torch.Tensor:
    """SLIC's connectivity repair of (B, H, W) labels in [0, k):
    `_absorb_orphans(labels, absorb_sweeps)`, then
    `enforce_connectivity(..., k, max_sweeps)`.  One kernel launch on the
    card; the plain versions on the CPU."""
    if labels.device.type == "cpu":
        return enforce_connectivity_plain(
            absorb_orphans_plain(labels, absorb_sweeps), k, max_sweeps)
    return repair_connectivity_cuda(labels, k, absorb_sweeps, max_sweeps)


def _absorb_orphans(labels: torch.Tensor, n_sweeps: int = 2) -> torch.Tensor:
    """A pixel none of whose 4-neighbours shares its label adopts the most
    frequent neighbouring label (checkerboard half-sweeps), for (B, H, W)
    labels (on the card: in [0, 2^31))."""
    if labels.device.type == "cpu":
        return absorb_orphans_plain(labels, n_sweeps)
    return repair_connectivity_cuda(labels, 1, n_sweeps, 0)


def enforce_connectivity(labels: torch.Tensor, k: int,
                         max_sweeps: int = 64) -> torch.Tensor:
    """Make every label of each (H, W) image of `labels` (B, H, W), in
    [0, k), one connected region: min-index components, keep each label's
    largest component, minor fragments adopt a neighbouring major label.
    Loops test convergence once per block of steps, as the JAX while loops
    do, and each image stops on its own."""
    if labels.device.type == "cpu":
        return enforce_connectivity_plain(labels, k, max_sweeps)
    return repair_connectivity_cuda(labels, k, 0, max_sweeps)
