"""The synthetic training batch, plainly: from a batch of poses, texture
atlases and backgrounds and the state of the random source, the targets,
the render, the crop, the augmentations and the 18-channel proxy that
HuManiFlow trains on (reference train_humaniflow.py:113-245).

Every random number is drawn from a torch.Generator restored to the given
state, in the order and shapes in which the training recipe draws them, so
that the same state gives the same numbers.  The render is an exact
z-buffer over the DensePose faces: each pixel centre in a face's bounding
box (widened by one pixel) is tested with the face's edge-plane
coefficients; the nearest depth wins, the lowest face id on a tie; faces
facing away from the camera are culled; a face's colour is its centroid's
nearest texel, lit by flat Lambert shading with ambient and diffuse white
light.
"""

import math
from functools import lru_cache

import numpy as np
import torch

from .common import so3_exp
from .proxy import canny, heatmaps
from .smpl import smpl_forward

BIG_DEPTH = 1e9
ALL_JOINTS_TO_COCO = [24, 26, 25, 28, 27, 16, 17, 18, 19, 20, 21, 1, 2, 4, 5, 7, 8]
PART_TO_COCO_JOINT = {19: 7, 21: 7, 20: 8, 22: 8, 4: 9, 3: 10, 12: 13, 14: 13, 11: 14, 13: 14, 5: 15, 6: 16}
DP24_TO_14 = [0, 1, 1, 11, 12, 14, 13, 8, 6, 8, 6, 9, 7, 9, 7, 2, 4, 2, 4, 3, 5, 3, 5, 10, 10]
JOINT_TO_PART14 = {7: 3, 8: 5, 9: 12, 10: 11, 13: 7, 14: 9, 15: 14, 16: 13}
LEGS = (5, 6, 7, 8, 9, 10, 11, 12, 13, 14)
LEGS_ARMS = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 19, 20, 21, 22)
CANDIDATES = 1 << 24  # (face, pixel) candidates tested at once


@lru_cache(maxsize=2)
def densepose_tables(mat_path: str):
    """faces (13774, 3) into the DensePose vertices, vertex_map (7829,) into
    SMPL's, per-face part ids and the atlas coordinates of each face's
    centroid (SURREAL's 4 × 6 tiles of parts), as numpy arrays."""
    from scipy.io import loadmat

    m = loadmat(mat_path)
    faces = np.asarray(m["All_Faces"], np.int64) - 1
    vertex_map = np.asarray(m["All_vertices"], np.int64)[0] - 1
    face_part = np.asarray(m["All_FaceIndices"], np.int64)[:, 0]
    u = np.asarray(m["All_U_norm"], np.float64)[:, 0]
    v = np.asarray(m["All_V_norm"], np.float64)[:, 0]
    vert_part = np.zeros(vertex_map.shape[0], np.int64)
    vert_part[faces.reshape(-1)] = np.repeat(face_part, 3)
    atlas_u = ((vert_part - 1) % 4 + u) / 4.0
    atlas_v = ((vert_part - 1) // 4 + (1.0 - v)) / 6.0
    return {"faces": faces, "vertex_map": vertex_map, "face_part": face_part,
            "face_atlas_u": atlas_u[faces].mean(1).astype(np.float32),
            "face_atlas_v": atlas_v[faces].mean(1).astype(np.float32)}


class Source:
    """The random numbers of one batch, from a generator at `state`."""

    def __init__(self, state: torch.Tensor, device):
        self.g = torch.Generator(device)
        self.g.set_state(state)
        self.device = device

    def normal(self, shape):
        return torch.randn(tuple(shape), generator=self.g, device=self.device)

    def uniform(self, shape, lo=0.0, hi=1.0):
        return torch.rand(tuple(shape), generator=self.g, device=self.device) * (hi - lo) + lo

    def randint(self, shape, lo, hi):
        return torch.randint(lo, hi, tuple(shape), generator=self.g, device=self.device)


def _rotate_x_pi(points):
    """Points (B, N, 3) turned by π about the x axis, as the recipe flips
    the body to y-up."""
    r = torch.tensor([math.pi, 0.0, 0.0], device=points.device).expand(points.shape[0], 3)
    return torch.einsum("bij,bkj->bki", so3_exp(r), points)


def _unit(v, eps):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def _masked(img, mask):
    if img.dim() == 4:
        mask = mask[..., None]
    return torch.where(mask, torch.zeros((), dtype=img.dtype, device=img.device), img)


def _order_keys(z, face_ids):
    """int64 keys ordered by z, then by face id."""
    bits = z.contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits >= 0, bits + (1 << 31), -1 - bits)
    return (ordered - (1 << 31)) * (1 << 32) + face_ids


def zbuffer(screen, faces, size: int):
    """Winning face id (B, H, W) (−1 where none) of the meshes' screen
    coordinates (B, V, 3) (x = column, y = row, depth), back faces culled."""
    b = screen.shape[0]
    dev = screen.device
    tri = screen[:, faces]  # (B, F, 3, 3)
    x, y, z = tri[..., 0], tri[..., 1], tri[..., 2]
    x0, y0, z0, x1, y1, z1, x2, y2, z2 = (x[..., 0], y[..., 0], z[..., 0], x[..., 1], y[..., 1], z[..., 1],
                                          x[..., 2], y[..., 2], z[..., 2])
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    valid = torch.abs(area) > 1e-9
    inv = valid.to(area.dtype) / torch.where(valid, area, torch.ones_like(area))
    a0, b0, c0 = -(y2 - y1) * inv, (x2 - x1) * inv, ((y2 - y1) * x1 - (x2 - x1) * y1) * inv
    a1, b1, c1 = -(y0 - y2) * inv, (x0 - x2) * inv, ((y0 - y2) * x2 - (x0 - x2) * y2) * inv
    za, zb = a0 * (z0 - z2) + a1 * (z1 - z2), b0 * (z0 - z2) + b1 * (z1 - z2)
    zc = c0 * (z0 - z2) + c1 * (z1 - z2) + z2
    keep = torch.isfinite(tri).all(dim=-1).all(dim=-1) & valid & (area > 0)
    x_lo, y_lo = torch.floor(x.amin(-1)) - 1.0, torch.floor(y.amin(-1)) - 1.0
    x_hi, y_hi = torch.ceil(x.amax(-1)) + 1.0, torch.ceil(y.amax(-1)) + 1.0
    x_lo, y_lo = torch.clamp(x_lo, min=0.0), torch.clamp(y_lo, min=0.0)
    x_hi, y_hi = torch.clamp(x_hi, max=size - 1.0), torch.clamp(y_hi, max=size - 1.0)
    keep &= (x_hi >= x_lo) & (y_hi >= y_lo)
    best = torch.full((b * size * size,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=dev)
    mesh, face = torch.nonzero(keep, as_tuple=True)
    ext_x = (x_hi - x_lo)[mesh, face].long() + 1
    ext_y = (y_hi - y_lo)[mesh, face].long() + 1
    # faces by box extent, smallest first; a group is as many faces as one
    # k × k grid of candidates each (k its largest extent) lets CANDIDATES hold
    extent = torch.maximum(ext_x, ext_y)
    order = torch.argsort(extent)
    mesh, face, extent = mesh[order], face[order], extent[order]
    n, start = mesh.shape[0], 0
    while start < n:
        group = min(max(1, CANDIDATES // int(extent[start]) ** 2), n - start)
        group = min(group, max(1, CANDIDATES // int(extent[start + group - 1]) ** 2))
        kx = ky = int(extent[start + group - 1])
        m, f = mesh[start:start + group], face[start:start + group]
        dx = torch.arange(kx, device=dev, dtype=torch.float32)
        dy = torch.arange(ky, device=dev, dtype=torch.float32)
        cols = x_lo[m, f][:, None, None] + dx[None, None, :]
        rows = y_lo[m, f][:, None, None] + dy[None, :, None]
        gx, gy = cols + 0.5, rows + 0.5
        c = lambda t: t[m, f][:, None, None]  # noqa: E731
        w0 = (c(a0) * gx + c(b0) * gy) + c(c0)
        w1 = (c(a1) * gx + c(b1) * gy) + c(c1)
        w2 = (1.0 - w0) - w1
        depth = (c(za) * gx + c(zb) * gy) + c(zc)
        hit = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (cols <= c(x_hi)) & (rows <= c(y_hi))
               & torch.isfinite(depth) & (depth < BIG_DEPTH))
        pix = (m[:, None, None] * size + rows.long()) * size + cols.long()
        keys = _order_keys(depth, f[:, None, None].expand(depth.shape))
        best.scatter_reduce_(0, pix[hit], keys[hit], reduce="amin")
        start += group
    best = best.reshape(b, size, size)
    empty = best == torch.iinfo(torch.int64).max
    return torch.where(empty, -1, best & 0xFFFFFFFF)


def render(verts, cam_t, texture, lights, tables, focal: float, size: int):
    """(part ids (B, H, W) float, lit RGB (B, H, W, 3)) of SMPL vertices
    (already flipped) at camera translation cam_t."""
    dev = verts.device
    dp = verts[:, torch.as_tensor(tables["vertex_map"], device=dev)]
    faces = torch.as_tensor(tables["faces"], device=dev)
    v = dp + cam_t[:, None, :]
    zc = torch.clamp(v[..., 2:3], min=1e-6)
    screen = torch.cat([v[..., :2] / zc * focal + size / 2.0, v[..., 2:3]], dim=-1)
    fid = zbuffer(screen, faces, size)
    mask = fid >= 0
    fidx = torch.clamp(fid, min=0)

    b, th, tw = texture.shape[:3]
    tu = torch.as_tensor(tables["face_atlas_u"], device=dev)
    tv = torch.as_tensor(tables["face_atlas_v"], device=dev)
    tx = torch.round(torch.clamp(tu * (tw - 1), 0, tw - 1)).long()
    ty = torch.round(torch.clamp(tv * (th - 1), 0, th - 1)).long()
    texel = texture.reshape(b, th * tw, 3)[:, ty * tw + tx]  # (B, F, 3)
    tri = dp[:, faces]
    n = _unit(torch.linalg.cross(tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0], dim=-1), 1e-12)
    ldir = _unit(lights["location"][:, None, :] - tri.mean(dim=2), 1e-8)
    lam = torch.abs(torch.sum(n * ldir, dim=-1, keepdim=True))
    lit = texel * (lights["ambient"][:, None, :] + lights["diffuse"][:, None, :] * lam)
    bi = torch.arange(b, device=dev)[:, None, None]
    rgb = torch.where(mask[..., None], torch.clamp(lit[bi, fidx], 0.0, 1.0), 0.0)
    part = torch.where(mask, torch.as_tensor(tables["face_part"], device=dev)[fidx], 0).to(torch.float32)
    return part, rgb


def _resample(src, size, mode):
    """(B, O, size) interpolation matrix of source coordinates src (B, O),
    and the in-range mask; half-pixel centres, taps out of range weigh 0."""
    ar = torch.arange(size, device=src.device)
    if mode == "nearest":
        idx = torch.round(src).to(torch.int64)
        return (idx[..., None] == ar).to(torch.float32), (idx >= 0) & (idx < size)
    x0 = torch.floor(src)
    w1 = (src - x0)[..., None]
    i0 = x0.to(torch.int64)[..., None]
    return ((i0 == ar) * (1.0 - w1) + ((i0 + 1) == ar) * w1).to(torch.float32), (src >= 0.0) & (src <= size - 1.0)


def _sample(img, src_x, src_y, mode, pad):
    _, h, w, _ = img.shape
    my, vy = _resample(src_y, h, mode)
    mx, vx = _resample(src_x, w, mode)
    out = torch.einsum("bpw,bowc->bopc", mx, torch.einsum("boh,bhwc->bowc", my, img.float()))
    if pad != 0.0:
        out = torch.where((vy[:, :, None] & vx[:, None, :])[..., None], out, torch.full_like(out, pad))
    return out


def crop(src: Source, part, rgb, joints2d, box_from, size: int, scale_factor, scale_range, centre_range):
    """The box of box_from's nonzero pixels, aspect-matched, scaled by
    scale_factor plus a drawn delta, its centre moved by a drawn delta,
    resampled to size² (parts nearest, −1 outside the image; RGB bilinear)."""
    b, h, w = box_from.shape
    on = box_from != 0
    rows = torch.arange(h, dtype=torch.float32, device=on.device)[None, :, None].expand(b, h, w)
    cols = torch.arange(w, dtype=torch.float32, device=on.device)[None, None, :].expand(b, h, w)
    big = torch.tensor(1e9, device=on.device)
    y1, x1 = torch.where(on, rows, big).amin(dim=(1, 2)), torch.where(on, cols, big).amin(dim=(1, 2))
    y2, x2 = torch.where(on, rows, -big).amax(dim=(1, 2)), torch.where(on, cols, -big).amax(dim=(1, 2))
    centres = torch.stack([(y1 + y2) / 2.0, (x1 + x2) / 2.0], dim=-1)
    bh, bw = y2 - y1, x2 - x1
    wdt = torch.where(bh > bw, bh, bw)  # a square output: aspect 1
    hgt = torch.where(bh < bw, wdt, bh)
    factor = scale_factor + src.uniform(bh.shape, *scale_range)
    hgt, wdt = hgt * factor, wdt * factor
    centres = centres + src.uniform(centres.shape, *centre_range)
    scale = torch.stack([size / wdt, size / hgt], dim=-1)
    trans = torch.tensor([size * 0.5, size * 0.5], device=scale.device) - scale * centres[:, [1, 0]]
    grid = torch.arange(size, dtype=torch.float32, device=scale.device)
    src_x = (grid[None] + 0.5 - trans[:, 0, None]) / scale[:, 0, None] - 0.5
    src_y = (grid[None] + 0.5 - trans[:, 1, None]) / scale[:, 1, None] - 0.5
    part = _sample(part[..., None], src_x, src_y, "nearest", -1.0)[..., 0]
    rgb = _sample(rgb, src_x, src_y, "bilinear", 0.0)
    return part, rgb, joints2d * scale[:, None, :] + trans[:, None, :]


def _visible(j2d, size, vis):
    x, y = j2d[..., 0], j2d[..., 1]
    return vis & (x >= 0) & (x <= size) & (y >= 0) & (y <= size)


def _half(src: Source, img, j2d, vis, prob, where: str):
    """A half of the image (bottom, top or a vertical side) blanked with
    probability prob, its joints made invisible."""
    b, h, w = img.shape[:3]
    extent = w if where == "vertical" else h
    apply = src.uniform((b,)) < prob
    jit = extent // (30 if where == "vertical" else 5)
    cut = extent // 2 + src.randint((b,), -jit, jit)
    rows = torch.arange(h, device=img.device)[None, :, None].expand(b, h, w)
    cols = torch.arange(w, device=img.device)[None, None, :].expand(b, h, w)
    c3 = cut[:, None, None]
    if where == "bottom":
        px, jt = rows >= c3, j2d[..., 1] > cut[:, None]
    elif where == "top":
        px, jt = rows < c3, j2d[..., 1] < cut[:, None]
    else:
        left = src.uniform((b,)) > 0.5
        px = torch.where(left[:, None, None], cols < c3, cols >= c3)
        jt = torch.where(left[:, None], j2d[..., 0] < cut[:, None], j2d[..., 0] > cut[:, None])
    return _masked(img, apply[:, None, None] & px), vis & ~(apply[:, None] & jt)


def corrupt_proxy(src: Source, seg, j2d, vis, aug):
    """Parts removed (and with them, maybe, their joint), a box occluded,
    joint pairs swapped, joints moved, some made invisible, image halves
    occluded."""
    b, h, w = seg.shape
    vis = vis.clone()
    for cls, prob in zip(aug["REMOVE_PARTS_CLASSES"], aug["REMOVE_PARTS_PROBS"]):
        apply = src.uniform((b,)) < prob
        seg = _masked(seg, apply[:, None, None] & (seg == cls))
        if cls in PART_TO_COCO_JOINT:
            j = PART_TO_COCO_JOINT[cls]
            vis[:, j] &= ~(apply & (src.uniform((b,)) < aug["REMOVE_APPENDAGE_JOINTS_PROB"]))
    apply = src.uniform((b,)) < aug["OCCLUDE_BOX_PROB"]
    cy = src.uniform((b,), h / 2 - 0.15 * h, h / 2 + 0.15 * h)
    cx = src.uniform((b,), w / 2 - 0.15 * w, w / 2 + 0.15 * w)
    half = aug["OCCLUDE_BOX_DIM"] / 2
    rows = torch.arange(h, device=seg.device)[None, :, None].expand(b, h, w)
    cols = torch.arange(w, device=seg.device)[None, None, :].expand(b, h, w)
    box = ((rows >= (cy - half)[:, None, None]) & (rows < (cy + half)[:, None, None])
           & (cols >= (cx - half)[:, None, None]) & (cols < (cx + half)[:, None, None]))
    seg = _masked(seg, apply[:, None, None] & box)
    for a, c in aug["JOINTS_TO_SWAP"]:
        apply = (src.uniform((b,)) < aug["JOINTS_SWAP_PROB"])[:, None]
        ja, jc = j2d[:, a], j2d[:, c]
        j2d = j2d.clone()
        j2d[:, a], j2d[:, c] = torch.where(apply, jc, ja), torch.where(apply, ja, jc)
    k = j2d.shape[1]
    dev = src.uniform((b, k, 2), *aug["DELTA_J2D_DEV_RANGE"])
    hip_dev = src.uniform((b, k, 2), *aug["DELTA_J2D_DEV_RANGE"])
    hips = torch.zeros((k,), dtype=torch.bool, device=j2d.device)
    hips[[11, 12]] = True
    j2d = j2d + torch.where(hips[None, :, None], hip_dev, dev)
    for j in aug["REMOVE_JOINTS_INDICES"]:
        vis[:, j] &= ~(src.uniform((b,)) < aug["REMOVE_JOINTS_PROB"])
    for where, key in (("bottom", "OCCLUDE_BOTTOM_PROB"), ("top", "OCCLUDE_TOP_PROB"),
                       ("vertical", "OCCLUDE_VERTICAL_PROB")):
        seg, vis = _half(src, seg, j2d, vis, aug[key], where)
    return seg, j2d, vis


def synth_batch(state, pose72, texture, background, smpl, config, mat_path: str):
    """The batch dict (proxy, pose_rotmats, glob_rotmats, shape, joints2D,
    joints2D_vis, rgb_in) of one synthetic batch."""
    sd, data = config["TRAIN"]["SYNTH_DATA"], config["DATA"]
    aug, size, focal = sd["AUGMENT"], data["PROXY_REP_SIZE"], sd["FOCAL_LENGTH"]
    dev = pose72.device
    src = Source(state, dev)
    b, nb = pose72.shape[0], config["MODEL"]["NUM_SMPL_BETAS"]
    tables = densepose_tables(mat_path)

    pose_r = so3_exp(pose72.reshape(b, 24, 3))
    body_r = pose_r[:, 1:]
    glob_r = torch.matmul(pose_r[:, 0], so3_exp(torch.tensor([math.pi, 0.0, 0.0], device=dev)).expand(b, 3, 3))
    shape = src.normal((b, nb)) * aug["SMPL"]["SHAPE_STD"]
    mean_t = torch.tensor(sd["MEAN_CAM_T"], device=dev).expand(b, 3)
    dxy = src.normal((b, 2)) * aug["CAM"]["XY_STD"]
    dz = src.uniform((b,), *aug["CAM"]["DELTA_Z_RANGE"])
    cam_t = torch.cat([mean_t[:, :2] + dxy, (mean_t[:, 2] + dz)[:, None]], dim=-1)
    verts, joints = smpl_forward(smpl, shape, body_r, glob_r)

    verts = _rotate_x_pi(verts)
    joints = _rotate_x_pi(joints[:, ALL_JOINTS_TO_COCO])
    p = joints + cam_t[:, None, :]
    j2d = p[..., :2] / p[..., 2:3] * focal + size / 2.0
    vis = _visible(j2d, size, torch.ones(j2d.shape[:2], dtype=torch.bool, device=dev))
    rgb_aug = aug["RGB"]
    lights = {k: src.uniform((1, 1), *rgb_aug[r]).expand(1, 3) for k, r in (
        ("ambient", "LIGHT_AMBIENT_RANGE"), ("diffuse", "LIGHT_DIFFUSE_RANGE"), ("specular", "LIGHT_SPECULAR_RANGE"))}
    direction = src.normal((1, 3))
    lights["location"] = direction / torch.linalg.norm(direction, dim=-1, keepdim=True) * src.uniform(
        (1, 1), *rgb_aug["LIGHT_LOC_RANGE"])
    part, rgb = render(verts, cam_t, texture, lights, tables, focal, size)

    # extreme crops: the legs (or legs and arms) left out of the box
    seg = part.to(torch.int32)
    r = src.uniform((b,))
    p_ext = aug["PROXY_REP"]["EXTREME_CROP_PROB"]
    do_legs, do_arms = r < p_ext * 0.5, (r > p_ext * 0.5) & (r < p_ext)
    seg = _masked(seg, do_legs[:, None, None] & torch.isin(seg, torch.tensor(LEGS, device=dev)))
    seg = _masked(seg, do_arms[:, None, None] & torch.isin(seg, torch.tensor(LEGS_ARMS, device=dev)))
    part, rgb, j2d = crop(src, part, rgb, j2d, seg.to(torch.float32),
                          size, data["BBOX_SCALE_FACTOR"], aug["BBOX"]["DELTA_SCALE_RANGE"],
                          aug["BBOX"]["DELTA_CENTRE_RANGE"])
    seg = torch.round(part).to(torch.int32)

    vis = _visible(j2d, size, vis)
    seg14 = torch.tensor(DP24_TO_14, device=dev)[torch.clamp(seg, min=0).long()]
    occluded = vis.clone()
    for j, p14 in JOINT_TO_PART14.items():
        occluded[:, j] = vis[:, j] & (torch.sum(seg14 == p14, dim=(1, 2)) > 50)
    vis = occluded

    seg_aug, j2d_in, vis = corrupt_proxy(src, seg, j2d, vis, aug["PROXY_REP"])
    rgb = torch.where((seg_aug != 0)[..., None], rgb, background)
    for where, key in (("bottom", "OCCLUDE_BOTTOM_PROB"), ("top", "OCCLUDE_TOP_PROB"),
                       ("vertical", "OCCLUDE_VERTICAL_PROB")):
        rgb, vis = _half(src, rgb, j2d_in, vis, rgb_aug[key], where)
    noise = src.uniform((b, 1, 1, 3), 1 - rgb_aug["PIXEL_CHANNEL_NOISE"], 1 + rgb_aug["PIXEL_CHANNEL_NOISE"])
    rgb = torch.clamp(rgb * noise, max=1.0)

    hm = heatmaps(j2d_in, size, data["HEATMAP_GAUSSIAN_STD"]) * vis.to(torch.float32)[:, :, None, None]
    return {"proxy": torch.cat([canny(rgb, data), hm.permute(0, 2, 3, 1)], dim=-1), "pose_rotmats": body_r,
            "glob_rotmats": glob_r, "shape": shape, "joints2D": j2d, "joints2D_vis": vis.to(torch.float32),
            "rgb_in": rgb}
