"""Occupancy-grid world: map files, the distance field, sphere-traced lidar
and map collision checks.

Port of ``irbfn_tpu/sim/map.py``. The distance field is computed once on the
host (scipy's exact Euclidean distance transform, as the reference's scan
simulator does) and then lives on the map's device as one (H, W) tensor;
lidar is sphere tracing of that field, every (pose, beam) pair at once, a
fixed number of bilinear-gather iterations.

Map bundles are the reference's ROS map-server format: a yaml file with the
flat keys ``image``, ``resolution``, ``origin``, ``negate``,
``occupied_thresh`` and ``free_thresh``, beside an 8-bit image. Both are read
and written here without PyYAML or Pillow: the yaml reader takes exactly
those flat keys (lists in flow or block style), and the image codec reads
8-bit non-interlaced PNG (grey, grey+alpha, RGB, RGBA; filters 0-4) and
binary PGM (P5), and writes 8-bit grey PNG. Anything else raises.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import NamedTuple

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device


class OccupancyMap(NamedTuple):
    """Distance-transformed occupancy grid in world coordinates.

    ``dist[r, c]`` is the distance (meters) from cell (row r, col c) to the
    nearest obstacle; row 0 is the map origin's corner (images are flipped
    top-bottom at load). The rest are 0-dim tensors on the same device."""

    dist: torch.Tensor  # (H, W) meters to the nearest obstacle
    origin_x: torch.Tensor  # world x of grid corner (0, 0)
    origin_y: torch.Tensor
    origin_c: torch.Tensor  # cos/sin of the map origin's rotation
    origin_s: torch.Tensor
    resolution: torch.Tensor  # meters per cell


class ScanSpec(NamedTuple):
    """Scanner geometry (the f1tenth 270-degree scanner's defaults)."""

    n_beams: int = 64
    fov: float = 4.7
    max_range: float = 30.0
    n_iters: int = 64  # sphere-trace iterations (fixed trip count)
    eps: float = 1e-4  # hit threshold, meters


# ------------------------------------------------------------- device side

def _as(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, device=like.device)


def distance_at(omap: OccupancyMap, x, y):
    """Bilinear sample of the distance field at world points, batched over
    leading axes. Points outside the map read 0 (an obstacle)."""
    d = omap.dist
    x, y = _as(x, d), _as(y, d)
    xt = x - omap.origin_x
    yt = y - omap.origin_y
    xr = xt * omap.origin_c + yt * omap.origin_s
    yr = -xt * omap.origin_s + yt * omap.origin_c
    # continuous cell coordinates; dist[r, c] lives at the cell's center
    cc = xr / omap.resolution - 0.5
    rr = yr / omap.resolution - 0.5
    h, w = d.shape
    r0 = torch.clamp(torch.floor(rr).to(torch.int64), 0, h - 2)
    c0 = torch.clamp(torch.floor(cc).to(torch.int64), 0, w - 2)
    fr = torch.clamp(rr - r0.to(rr.dtype), 0.0, 1.0)
    fc = torch.clamp(cc - c0.to(cc.dtype), 0.0, 1.0)
    flat = d.reshape(-1)
    i00 = r0 * w + c0
    d00, d01 = flat[i00], flat[i00 + 1]
    d10, d11 = flat[i00 + w], flat[i00 + w + 1]
    out = ((1 - fr) * ((1 - fc) * d00 + fc * d01)
           + fr * ((1 - fc) * d10 + fc * d11))
    inside = ((xr >= 0) & (xr < w * omap.resolution)
              & (yr >= 0) & (yr < h * omap.resolution))
    return torch.where(inside, out, torch.zeros_like(out))


def beam_angles(spec: ScanSpec, dtype, device) -> torch.Tensor:
    """The scan's beam angles, ``linspace(-fov/2, fov/2, n_beams)`` as the
    JAX package computes it: start * (1 - i/n) + stop * i/n, then stop."""
    n = spec.n_beams - 1
    lo = torch.tensor(-spec.fov / 2, dtype=dtype, device=device)
    hi = torch.tensor(spec.fov / 2, dtype=dtype, device=device)
    if n == 0:
        return lo[None]
    step = torch.arange(n, dtype=dtype, device=device) / n
    return torch.cat([lo * (1 - step) + hi * step, hi[None]])


def trace_rays(omap: OccupancyMap, x, y, theta, spec: ScanSpec = ScanSpec()):
    """A scan by sphere tracing the distance field: each ray advances by the
    clearance sampled at its tip, ``spec.n_iters`` times, every (pose,
    beam) pair at once. Returns ranges (..., n_beams)."""
    d = omap.dist
    x, y, theta = _as(x, d), _as(y, d), _as(theta, d)
    dt = torch.promote_types(torch.promote_types(x.dtype, theta.dtype),
                             d.dtype)
    bt = theta.to(dt)[..., None] + beam_angles(spec, dt, d.device)
    cx, sy = torch.cos(bt), torch.sin(bt)
    px = x.to(dt)[..., None].expand(bt.shape)
    py = y.to(dt)[..., None].expand(bt.shape)
    total = torch.zeros_like(bt)
    zero = torch.zeros((), dtype=dt, device=d.device)
    for _ in range(spec.n_iters):
        dist = distance_at(omap, px, py)
        live = (dist > spec.eps) & (total <= spec.max_range)
        step = torch.where(live, dist, zero)
        px = px + step * cx
        py = py + step * sy
        total = total + step
    return torch.clamp(total, max=spec.max_range)


def map_clearance(omap: OccupancyMap, x, y, radius=0.0):
    """Clearance of a disc footprint to the map geometry (negative =
    collision)."""
    return distance_at(omap, x, y) - radius


def footprint_clearance(omap: OccupancyMap, x, y, theta,
                        length: float = 0.58, width: float = 0.31,
                        n_discs: int = 5):
    """Rectangle-footprint clearance by a chain of ``n_discs`` covering
    discs of radius sqrt((L/2n)^2 + (W/2)^2) spaced along the heading: they
    cover the (length x width) rectangle, conservative by r - W/2 (~1 cm at
    car scale with n = 5). Negative = collision."""
    d = omap.dist
    x, y, theta = _as(x, d), _as(y, d), _as(theta, d)
    seg = length / n_discs
    r = float(np.sqrt((seg / 2.0) ** 2 + (width / 2.0) ** 2))
    offs = (torch.arange(n_discs, dtype=x.dtype, device=d.device)
            - (n_discs - 1) / 2.0) * seg
    cx = x[..., None] + offs * torch.cos(theta)[..., None]
    cy = y[..., None] + offs * torch.sin(theta)[..., None]
    return torch.amin(distance_at(omap, cx, cy), dim=-1) - r


# --------------------------------------------------------------- host side

def from_bitmap(free: np.ndarray, resolution: float, origin=(0.0, 0.0, 0.0),
                dtype=torch.float32, device=None) -> OccupancyMap:
    """An OccupancyMap from a binary grid (nonzero = free space, row 0 = the
    origin's corner), on ``device`` (None: the card). The exact Euclidean
    distance transform runs once on the host."""
    from scipy.ndimage import distance_transform_edt

    dist = resolution * distance_transform_edt(np.asarray(free) != 0)
    ox, oy, oth = (float(v) for v in origin)
    device = resolve_device(device)

    def t(v):
        return torch.tensor(np.asarray(v), dtype=dtype, device=device)

    return OccupancyMap(t(dist), t(ox), t(oy), t(np.cos(oth)),
                        t(np.sin(oth)), t(resolution))


def _scalar(text: str):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    return text


def read_map_yaml(path: str) -> dict:
    """The flat keys of a ROS map-server yaml file, as strings (``origin``
    as a list of strings). Lists may be in flow (``[a, b, c]``) or block
    (``- a`` lines) style. Nested mappings or other structure raise."""
    spec, key = {}, None
    with open(path) as f:
        for n, raw in enumerate(f, 1):
            line = raw.split(" #")[0].rstrip()
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            stripped = line.strip()
            if stripped.startswith("- ") or stripped == "-":
                if key is None or not isinstance(spec.get(key), list):
                    raise ValueError(f"{path}:{n}: a list item outside a "
                                     f"list: {raw!r}")
                spec[key].append(_scalar(stripped[1:]))
                continue
            if line[0] in " \t" or ":" not in line:
                raise ValueError(f"{path}:{n}: not a flat 'key: value' map "
                                 f"line: {raw!r}")
            key, _, value = line.partition(":")
            key, value = key.strip(), value.strip()
            if not value:
                spec[key] = []
            elif value.startswith("["):
                if not value.endswith("]"):
                    raise ValueError(f"{path}:{n}: unclosed list {raw!r}")
                inner = value[1:-1].strip()
                spec[key] = ([_scalar(v) for v in inner.split(",")]
                             if inner else [])
            elif value[0] in "{&*|>!":
                raise ValueError(f"{path}:{n}: unsupported yaml value for "
                                 f"{key!r}: {value!r}")
            else:
                spec[key] = _scalar(value)
    for k in ("image", "resolution", "origin"):
        if k not in spec:
            raise ValueError(f"{path}: no {k!r} key")
    return spec


def _unfilter(raw: bytes, width: int, height: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-scanline filters (0 none, 1 sub, 2 up, 3 average,
    4 Paeth) on 8-bit samples; returns (height, width * bpp) uint8."""
    stride = width * bpp
    if len(raw) != height * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    data = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        ftype, row = int(data[r, 0]), data[r, 1:]
        if ftype == 0:
            cur = row.copy()
        elif ftype == 1:  # sub: a running sum per channel, mod 256
            cur = np.cumsum(row.reshape(width, bpp).astype(np.int64),
                            axis=0).reshape(-1).astype(np.uint8)
        elif ftype == 2:
            cur = (row.astype(np.int64) + prev).astype(np.uint8)
        elif ftype in (3, 4):
            cur = bytearray(row.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG filter type {ftype} is not one of 0-4")
        out[r] = cur
        prev = cur
    return out


# channels of the PNG colour types read here: grey, RGB, grey+alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def read_png(path: str) -> np.ndarray:
    """An 8-bit non-interlaced PNG as (H, W, channels) uint8."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(blob):
        n, = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        body = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{ctype}, interlace {interlace}); maps must be 8-bit, "
            "non-interlaced grey, grey+alpha, RGB or RGBA")
    bpp = _PNG_CHANNELS[ctype]
    pix = _unfilter(zlib.decompress(b"".join(idat)), width, height, bpp)
    return pix.reshape(height, width, bpp)


def read_pgm(path: str) -> np.ndarray:
    """A binary (P5) PGM with maxval <= 255 as (H, W, 1) uint8."""
    with open(path, "rb") as f:
        blob = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(blob) and blob[pos:pos + 1].isspace():
            pos += 1
        if blob[pos:pos + 1] == b"#":
            pos = blob.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(blob) and not blob[end:end + 1].isspace():
            end += 1
        fields.append(blob[pos:end])
        pos = end
    if fields[0] != b"P5":
        raise ValueError(f"{path}: only binary (P5) PGM is read")
    width, height, maxval = (int(v) for v in fields[1:])
    if maxval > 255:
        raise ValueError(f"{path}: 16-bit PGM (maxval {maxval}) is not read")
    data = np.frombuffer(blob[pos + 1:pos + 1 + width * height], np.uint8)
    return data.reshape(height, width, 1)


def to_grey(pix: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 -> (H, W) luma as Pillow's ``convert("L")`` gives it:
    alpha dropped, RGB weighted 299/587/114 in 16-bit fixed point."""
    if pix.shape[-1] in (1, 2):
        return pix[..., 0]
    rgb = pix[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def read_image(path: str) -> np.ndarray:
    """A map image (PNG or binary PGM, by its magic bytes) as (H, W) uint8
    grey, file orientation (row 0 = top)."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(b"\x89PNG"):
        return to_grey(read_png(path))
    if magic.startswith(b"P5"):
        return to_grey(read_pgm(path))
    raise ValueError(f"{path}: map images must be PNG or binary PGM (P5)")


def write_png(path: str, grey: np.ndarray) -> None:
    """(H, W) uint8 as an 8-bit grey, non-interlaced PNG (filter 0)."""
    grey = np.ascontiguousarray(grey, np.uint8)
    h, w = grey.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), grey], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def load_map_yaml(yaml_path: str, dtype=torch.float32,
                  device=None) -> OccupancyMap:
    """Load a ROS map-server yaml + image pair. Pixels are flipped
    top-bottom, inverted if ``negate``, and free where above 128."""
    spec = read_map_yaml(yaml_path)
    img_path = os.path.join(os.path.dirname(yaml_path), spec["image"])
    img = read_image(img_path)[::-1].astype(np.float32)
    if int(float(spec.get("negate", 0))):
        img = 255.0 - img
    origin = [float(v) for v in spec["origin"][:3]]
    return from_bitmap(img > 128.0, float(spec["resolution"]), origin, dtype,
                       device)


def save_map_yaml(omap_free: np.ndarray, resolution: float, origin,
                  yaml_path: str) -> None:
    """Write a yaml + png pair in the reference's map format (the inverse of
    ``load_map_yaml``): free cells 255, occupied 0, file orientation."""
    img = np.where(np.asarray(omap_free) != 0, 255, 0).astype(np.uint8)
    png_path = os.path.splitext(yaml_path)[0] + ".png"
    write_png(png_path, img[::-1])
    origin = [float(origin[0]), float(origin[1]),
              float(origin[2]) if len(origin) > 2 else 0.0]
    with open(yaml_path, "w") as f:
        f.write(f"image: {os.path.basename(png_path)}\n"
                f"resolution: {float(resolution)!r}\n"
                f"origin: [{', '.join(repr(v) for v in origin)}]\n"
                "negate: 0\noccupied_thresh: 0.45\nfree_thresh: 0.196\n")


def rasterize_track(track, half_width: float, resolution: float = 0.05,
                    margin: float = 1.0, dtype=torch.float32,
                    device=None) -> OccupancyMap:
    """Rasterize a Track's corridor into an occupancy grid: free space is
    every cell within ``half_width`` of the raceline polyline. The map goes
    to ``device`` (None: the track's)."""
    from scipy.ndimage import distance_transform_edt

    rl = track.raceline
    device = rl.xs.device if device is None else device
    xs = rl.xs.cpu().numpy().astype(np.float64)
    ys = rl.ys.cpu().numpy().astype(np.float64)
    lo = np.array([xs.min(), ys.min()]) - half_width - margin
    hi = np.array([xs.max(), ys.max()]) + half_width + margin
    w = int(np.ceil((hi[0] - lo[0]) / resolution))
    h = int(np.ceil((hi[1] - lo[1]) / resolution))
    # stamp the polyline densely enough that no cell is skipped, then the
    # distance to it decides what is free
    pts = np.stack([xs, ys], axis=-1)
    seg = np.roll(pts, -1, axis=0) - pts
    seg_len = np.linalg.norm(seg, axis=-1)
    n_sub = np.maximum(1, np.ceil(seg_len / (0.5 * resolution)).astype(int))
    all_xy = np.concatenate([
        pts[i] + np.linspace(0, 1, n_sub[i], endpoint=False)[:, None] * seg[i]
        for i in range(len(pts))])
    cc = ((all_xy[:, 0] - lo[0]) / resolution).astype(int)
    rr = ((all_xy[:, 1] - lo[1]) / resolution).astype(int)
    ok = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
    grid = np.ones((h, w), bool)
    grid[rr[ok], cc[ok]] = False
    free = resolution * distance_transform_edt(grid) <= half_width
    return from_bitmap(free, resolution, (lo[0], lo[1], 0.0), dtype, device)


def raceline_from_csv(csv_path: str, dtype=torch.float32, device=None):
    """Parse a reference raceline/centerline CSV (``;`` or ``,`` separated,
    ``#`` comments; racelines s;x;y;psi;kappa;vx[;ax]) into a Raceline on
    ``device`` (None: the card). Centerline files (x, y[, w_left, w_right])
    are told apart by their column count and get geometry-derived yaw and
    curvature and unit speed."""
    from irbfn_tpu_torch.sim.track import Raceline

    with open(csv_path) as f:
        for line in f:
            if line.strip() and not line.lstrip().startswith("#"):
                delim = ";" if ";" in line else ","
                break
        else:
            raise ValueError(f"no data rows in {csv_path}")
    raw = np.genfromtxt(csv_path, delimiter=delim, comments="#")
    if raw.shape[1] >= 6:  # raceline: s; x; y; psi; kappa; vx
        ss, xs, ys, yaws, ks, vxs = (raw[:, i] for i in range(6))
    else:  # centerline: x; y; [w_left; w_right]
        xs, ys = raw[:, 0], raw[:, 1]
        d = np.linalg.norm(np.diff(np.stack([xs, ys], -1), axis=0), axis=-1)
        ss = np.concatenate([[0.0], np.cumsum(d)])[:len(xs)]
        tang = np.gradient(np.stack([xs, ys], -1), axis=0)
        yaws = np.arctan2(tang[:, 1], tang[:, 0])
        ks = np.gradient(np.unwrap(yaws)) / np.maximum(np.gradient(ss), 1e-9)
        vxs = np.ones_like(xs)
    if np.hypot(xs[-1] - xs[0], ys[-1] - ys[0]) < 1e-6:  # closing duplicate
        ss, xs, ys, yaws, ks, vxs = (a[:-1] for a in
                                     (ss, xs, ys, yaws, ks, vxs))
    d = np.linalg.norm(np.roll(np.stack([xs, ys], -1), -1, axis=0)
                       - np.stack([xs, ys], -1), axis=-1)
    length = float(ss[-1] + d[-1])
    device = resolve_device(device)
    return Raceline(*[torch.tensor(np.asarray(a), dtype=dtype, device=device)
                      for a in (ss, xs, ys, yaws, ks, vxs, length)])


def load_track_bundle(map_dir: str, name: str | None = None,
                      dtype=torch.float32, prefer: str = "raceline",
                      device=None):
    """Load a reference-format track directory (``<name>_map.yaml`` +
    image, ``<name>_raceline.csv`` / ``<name>_centerline.csv``) into a
    ``(Track, OccupancyMap)`` pair on ``device`` (None: the card).
    ``prefer`` picks which line is tried first."""
    from irbfn_tpu_torch.sim.track import Track

    name = name or os.path.basename(os.path.normpath(map_dir))
    omap = load_map_yaml(os.path.join(map_dir, f"{name}_map.yaml"), dtype,
                         device)
    order = (("centerline", "raceline") if prefer == "centerline"
             else ("raceline", "centerline"))
    for suffix in order:
        csv_path = os.path.join(map_dir, f"{name}_{suffix}.csv")
        if os.path.exists(csv_path):
            return Track(raceline_from_csv(csv_path, dtype, device)), omap
    raise FileNotFoundError(
        f"no {name}_raceline.csv or {name}_centerline.csv in {map_dir}")
