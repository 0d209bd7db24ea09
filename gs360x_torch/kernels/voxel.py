"""Voxel-grid point-cloud downsampling on an explicit device (the port of
:mod:`gs360x.kernels.voxel`), as plain torch ops.

Voxel keys → a stable lexicographic sort → segment heads → segment
reductions, as in the JAX module. The keys are IEEE f32 ``floor((xyz −
min) / voxel)`` with a true division by a device tensor (torch divides by
a host scalar as a multiply by its reciprocal on the card), clipped to
2**30. The sort packs the three columns into one int64 key when each is
below 2**21 and runs three stable passes otherwise. The centroid's sums
reduce over the sorted segments (``torch.segment_reduce``), not with
atomics, so a run gives the same picks as every other run on the same
device; the per-segment minima are exact in any order. Outputs are the
picks themselves (one per occupied voxel), not the JAX module's padding.
The ``center`` pick runs there too, through the same segment minimum (the
JAX module groups it on the host); the target search, the spatial hash,
the adaptive octree and the sky dome are host numpy and logic, copied; the
searches count voxels on the device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

PACK_BITS = 21      # three columns below 2**21 pack into one int64 key


def grid_keys(xyz: torch.Tensor, voxel: float,
              xyz_min: torch.Tensor) -> torch.Tensor:
    """(N, 3) int32 voxel indices per point on ``xyz``'s device."""
    step = torch.tensor(voxel, dtype=torch.float32, device=xyz.device)
    ijk = torch.floor((xyz - xyz_min) / step)
    return ijk.clamp_(0.0, 2.0 ** 30).to(torch.int32)


def _lexsort_order(keys3: torch.Tensor) -> torch.Tensor:
    """The stable order of the rows by (k0, k1, k2), k0 first."""
    keys = keys3.to(torch.int64)
    if int(keys.max()) < 1 << PACK_BITS:
        packed = (keys[:, 0] << 2 * PACK_BITS) | (keys[:, 1] << PACK_BITS) \
            | keys[:, 2]
        return torch.sort(packed, stable=True).indices
    order = torch.arange(len(keys), device=keys.device)
    for col in (2, 1, 0):
        order = order[torch.sort(keys[order, col], stable=True).indices]
    return order


def _heads(k_sorted: torch.Tensor) -> torch.Tensor:
    """True where a sorted row starts a new voxel."""
    diff = (k_sorted[1:] != k_sorted[:-1]).any(dim=1)
    return torch.cat([torch.ones(1, dtype=torch.bool,
                                 device=k_sorted.device), diff])


def unique_voxel_count(xyz, voxel: float, xyz_min=None, *,
                       device: Optional[torch.device] = None) -> int:
    """Number of occupied voxels at the given edge length; ``xyz`` is an
    (N, 3) f32 array or a tensor (then on its own device)."""
    xyz = torch.as_tensor(xyz, dtype=torch.float32, device=device)
    if xyz.shape[0] == 0:
        return 0
    xyz_min = (xyz.min(dim=0).values if xyz_min is None
               else torch.as_tensor(xyz_min, dtype=torch.float32,
                                    device=xyz.device))
    keys = grid_keys(xyz, voxel, xyz_min)
    return int(_heads(keys[_lexsort_order(keys)]).sum())


def _voxel_reduce_impl(xyz: torch.Tensor, keys: torch.Tensor,
                       rand_bits: Optional[torch.Tensor], *,
                       representative: str,
                       xyz_min: Optional[torch.Tensor] = None,
                       voxel: Optional[float] = None) -> torch.Tensor:
    """The original index of each voxel's representative, one a voxel in
    the sorted order: the least original index (``first``), or the least
    score in the voxel — ``rand_bits`` (``random``), the squared distance
    to the voxel's centroid (``centroid``) or to the centre of its cube at
    ``voxel`` from ``xyz_min`` (``center``) — ties to the least sorted
    position, which is the least original index."""
    n = xyz.shape[0]
    order = _lexsort_order(keys)
    heads = _heads(keys[order])
    seg = torch.cumsum(heads, 0) - 1
    starts = torch.nonzero(heads)[:, 0]
    if representative == "first":
        # the stable sort puts each voxel's lowest original index first
        return order[starts]
    lengths = torch.diff(starts, append=starts.new_tensor([n]))

    if representative == "random":
        score = rand_bits[order]
    elif representative == "center":
        # closest to the cube center, in the f32 steps of the JAX module's
        # host arithmetic (an unclipped floor, then |p - c|² summed in order)
        step = torch.tensor(voxel, dtype=torch.float32, device=xyz.device)
        xyz_sorted = xyz[order]
        ijk = torch.floor((xyz_sorted - xyz_min) / step)
        d = xyz_sorted - (xyz_min + (ijk + 0.5) * step)
        d2 = d * d
        score = d2[:, 0] + d2[:, 1] + d2[:, 2]
    else:  # centroid: closest point to the voxel centroid
        xyz_sorted = xyz[order]
        sums = torch.segment_reduce(xyz_sorted, "sum", lengths=lengths,
                                    axis=0)
        target = sums / lengths.to(torch.float32)[:, None]
        d = (xyz_sorted - target[seg]).to(torch.float64)
        # |d|² as XLA computes it on the CPU, fma(d2, d2, fma(d1, d1,
        # d0 * d0)) in f32: an f64 product is exact, so each fma rounds
        # once (twice only where the f64 sum sits on an f32 midpoint)
        score = (d[:, 0] * d[:, 0]).to(torch.float32)
        for col in (1, 2):
            score = (d[:, col] * d[:, col] + score).to(torch.float32)

    seg_min = torch.segment_reduce(score, "min", lengths=lengths)
    cand = torch.nonzero(score <= seg_min[seg])[:, 0]
    first = _heads(seg[cand][:, None])          # the first candidate a voxel
    return order[cand[first]]


def voxel_downsample_by_size(xyz: np.ndarray, rgb: np.ndarray, voxel: float,
                             *, representative: str = "centroid",
                             seed: int = 0, device: torch.device,
                             xyz_dev: Optional[torch.Tensor] = None
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fixed-voxel downsample. Returns (xyz_out, rgb_out, pick_indices).

    Representative strategies match the reference: 'centroid' (closest to
    the voxel centroid), 'center' (closest to the voxel cube center),
    'first' (lowest original index), 'random'. ``xyz_dev``: ``xyz``
    already on ``device``.
    """
    xyz = np.asarray(xyz, np.float32)
    rgb = np.asarray(rgb, np.uint8)
    n = xyz.shape[0]
    if n == 0:
        return xyz, rgb, np.zeros((0,), np.int64)
    xyz_min = xyz.min(axis=0)
    if xyz_dev is None:
        xyz_dev = torch.from_numpy(xyz).to(device)
    min_dev = torch.from_numpy(xyz_min).to(device)
    keys = grid_keys(xyz_dev, float(voxel), min_dev)
    rand = None
    if representative == "random":
        rand = torch.from_numpy(np.random.default_rng(seed).random(n).astype(
            np.float32)).to(device)
    picks = _voxel_reduce_impl(xyz_dev, keys, rand,
                               representative=representative,
                               xyz_min=min_dev, voxel=float(voxel))
    pick = torch.sort(picks).values.cpu().numpy()
    return xyz[pick], rgb[pick], pick


def voxel_downsample_to_target(xyz, rgb, target_points: int, *,
                               tol_ratio: float = 0.02, max_iter: int = 32,
                               representative: str = "centroid",
                               log=print, device: torch.device):
    """Binary-search the voxel size whose occupied-voxel count hits the
    target (reference algorithm, counts evaluated on device)."""
    xyz = np.asarray(xyz, np.float32)
    rgb = np.asarray(rgb, np.uint8)
    n = xyz.shape[0]
    if n == 0 or target_points <= 0 or target_points >= n:
        return xyz, rgb, np.arange(n, dtype=np.int64)

    xyz_min = xyz.min(axis=0)
    extent = xyz.max(axis=0) - xyz_min
    vol = float(np.prod(np.maximum(extent, 1e-12)))
    v0 = (vol / float(target_points)) ** (1.0 / 3.0) if vol > 0 else 1e-3
    xyz_dev = torch.from_numpy(xyz).to(device)
    min_dev = torch.from_numpy(xyz_min).to(device)

    cache = {}

    def count(v):
        key = round(float(v), 12)
        if key not in cache:
            cache[key] = unique_voxel_count(xyz_dev, float(v), min_dev)
        return cache[key]

    lo = max(v0 / 64.0, 1e-9)
    hi = max(v0 * 64.0, lo * 2.0)
    shrink = 0
    while count(lo) < target_points and lo > 1e-9 and shrink < 32:
        lo = max(lo * 0.5, 1e-9)
        shrink += 1
    for _ in range(10):
        if count(hi) <= target_points:
            break
        hi *= 2.0

    best_v, best_diff = v0, float("inf")
    for it in range(1, max_iter + 1):
        mid = 0.5 * (lo + hi)
        c = count(mid)
        diff = abs(c - target_points)
        if diff < best_diff:
            best_diff, best_v = diff, mid
        log(f"[iter {it:02d}] voxel={mid:.6g}  unique={c:,}")
        if diff / float(target_points) <= tol_ratio:
            best_v = mid
            break
        if c > target_points:
            lo = mid
        else:
            hi = mid
    return voxel_downsample_by_size(xyz, rgb, best_v,
                                    representative=representative,
                                    device=device, xyz_dev=xyz_dev)


def spatial_hash_downsample(xyz, rgb, *, target_points: Optional[int] = None,
                            voxel_size: Optional[float] = None,
                            representative: str = "centroid", log=print,
                            device: torch.device):
    """One-pass approximate downsample: ≤3 probes refine the voxel size via
    an effective-dimension estimate (reference heuristic,
    ``gs360_PlyOptimizer.py:1033-1171``)."""
    xyz = np.asarray(xyz, np.float32)
    rgb = np.asarray(rgb, np.uint8)
    n = xyz.shape[0]
    if n == 0:
        return xyz, rgb, np.zeros((0,), np.int64)
    if voxel_size and voxel_size > 0:
        voxel = float(voxel_size)
    elif target_points and target_points > 0:
        target = int(max(1, min(n, target_points)))
        if target >= n:
            return xyz, rgb, np.arange(n, dtype=np.int64)
        xyz_min = xyz.min(axis=0)
        extent = xyz.max(axis=0) - xyz_min
        vol = float(np.prod(np.maximum(extent, 1e-12)))
        voxel = max((vol / target) ** (1.0 / 3.0) if vol > 0 else 1e-3, 1e-9)
        xyz_dev = torch.from_numpy(xyz).to(device)
        min_dev = torch.from_numpy(xyz_min).to(device)
        prev_v = prev_c = None
        for probe in range(1, 4):
            c = unique_voxel_count(xyz_dev, voxel, min_dev)
            log(f"[spatial-hash probe {probe}] voxel={voxel:.6g} "
                f"unique={c:,}")
            if c <= 0:
                break
            ratio = c / float(target)
            if abs(ratio - 1.0) <= 0.06 or probe >= 3:
                break
            if prev_v is not None and prev_c and c != prev_c \
                    and abs(voxel - prev_v) > 1e-12:
                try:
                    dim = math.log(c / prev_c) / math.log(prev_v / voxel)
                except (ValueError, ZeroDivisionError):
                    dim = 2.0
                dim = max(1.2, min(3.0, abs(dim))) if math.isfinite(dim) else 2.0
            else:
                dim = 1.45 if ratio < 0.2 else (1.7 if ratio < 0.5 else (
                    2.6 if ratio > 2.0 else 2.1))
            scale = min(2.8, max(0.12, ratio ** (1.0 / dim)))
            new_v = max(voxel * scale, 1e-9)
            prev_v, prev_c = voxel, c
            if abs(new_v - voxel) <= max(1e-9, voxel * 1e-4):
                break
            voxel = new_v
    else:
        return xyz, rgb, np.arange(n, dtype=np.int64)
    return voxel_downsample_by_size(xyz, rgb, voxel,
                                    representative=representative,
                                    device=device)


def adaptive_voxel_downsample(xyz, rgb, target_points: Optional[int], *,
                              weight_power: float = 1.0,
                              min_voxel_size: Optional[float] = None,
                              representative: str = "centroid",
                              max_depth: int = 12, seed: int = 0):
    """Octree splitting that prefers dense regions (host heap algorithm,
    reference ``gs360_PlyOptimizer.py:1174-1407``): repeatedly split the
    heaviest node until ~target leaves, then pick one representative per
    leaf."""
    import heapq
    from itertools import count as _count

    xyz = np.asarray(xyz, np.float32)
    rgb = np.asarray(rgb, np.uint8)
    n = xyz.shape[0]
    if n == 0:
        return xyz, rgb, np.zeros((0,), np.int64)
    target = n if not target_points or target_points <= 0 \
        else int(max(1, min(n, target_points)))
    if target >= n:
        return xyz, rgb, np.arange(n, dtype=np.int64)

    weight_power = max(0.0, float(weight_power))

    def weight(c):
        return 1.0 if weight_power == 0.0 else float(c) ** weight_power

    xyz_min = xyz.min(axis=0)
    extent = xyz.max(axis=0) - xyz_min
    cube = float(extent.max())
    if cube <= 0:
        keep = np.arange(target, dtype=np.int64)
        return xyz[keep], rgb[keep], keep
    cube_min = xyz_min - np.maximum((cube - extent) * 0.5, 0.0)

    seq = _count()
    heap = [(-weight(n), next(seq),
             (np.arange(n, dtype=np.int64), cube_min, cube, 0))]
    leaves = []
    eps = 1e-9

    def can_split(idx, size, depth):
        if len(idx) <= 1 or depth >= max_depth:
            return False
        if min_voxel_size and size <= min_voxel_size + eps:
            return False
        return size * 0.5 > eps

    while heap and len(heap) + len(leaves) < target:
        _, _, (idx, mn, size, depth) = heapq.heappop(heap)
        if not can_split(idx, size, depth):
            leaves.append((idx, mn, size))
            continue
        half = size * 0.5
        rel = xyz[idx] - mn
        octant = ((rel[:, 0] >= half).astype(np.int8) * 4
                  + (rel[:, 1] >= half).astype(np.int8) * 2
                  + (rel[:, 2] >= half).astype(np.int8))
        for o in range(8):
            sub = idx[octant == o]
            if len(sub) == 0:
                continue
            off = np.array([(o >> 2) & 1, (o >> 1) & 1, o & 1],
                           np.float32) * half
            heapq.heappush(heap, (-weight(len(sub)), next(seq),
                                  (sub, mn + off, half, depth + 1)))
    for _w, _s, (idx, mn, size, _depth) in heap:
        leaves.append((idx, mn, size))

    rng = np.random.default_rng(seed)
    picks = []
    for idx, mn, size in leaves:
        pts = xyz[idx]
        if representative == "first":
            picks.append(idx[0])
        elif representative == "random":
            picks.append(idx[rng.integers(len(idx))])
        elif representative == "center":
            center = mn + size * 0.5
            picks.append(idx[np.argmin(((pts - center) ** 2).sum(axis=1))])
        else:
            centroid = pts.mean(axis=0)
            picks.append(idx[np.argmin(((pts - centroid) ** 2).sum(axis=1))])
    pick = np.sort(np.asarray(picks, np.int64))[:target]
    return xyz[pick], rgb[pick], pick


# --------------------------------------------------------------------------
# sky dome synthesis (gs360_PlyOptimizer.py:244-302)
# --------------------------------------------------------------------------


def fibonacci_hemisphere(count: int, sky_percent: float = 50.0) -> np.ndarray:
    idx = np.arange(count, dtype=np.float32)
    phi = math.pi * (3.0 - math.sqrt(5.0))
    coverage = float(np.clip(sky_percent, 0.0, 100.0)) / 100.0
    z_min = 1.0 - 2.0 * coverage
    z = 1.0 - (idx / count) * (1.0 - z_min)
    radius = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([np.cos(phi * idx) * radius,
                     np.sin(phi * idx) * radius, z], axis=1)


def rotation_from_z_to(axis_vec: np.ndarray) -> np.ndarray:
    a = np.array([0.0, 0.0, 1.0])
    b = np.asarray(axis_vec, np.float64)
    b = b / max(np.linalg.norm(b), 1e-12)
    v = np.cross(a, b)
    c = float(a @ b)
    if np.linalg.norm(v) < 1e-12:
        return np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx * (1.0 / (1.0 + c))


def generate_sky_points(center, axis_vec, scale: float, count: int,
                        color, sky_percent: float = 50.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    samples = fibonacci_hemisphere(count, sky_percent) * float(scale)
    rot = rotation_from_z_to(axis_vec)
    world = samples @ rot.T + np.asarray(center, np.float64)
    colors = np.tile(np.asarray(color, np.uint8), (count, 1))
    return world.astype(np.float32), colors


SKY_AXES = {
    "+X": (1, 0, 0), "-X": (-1, 0, 0),
    "+Y": (0, 1, 0), "-Y": (0, -1, 0),
    "+Z": (0, 0, 1), "-Z": (0, 0, -1),
}
