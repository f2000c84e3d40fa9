"""SMPL forward and the per-vertex sample uncertainty, plain.

Arrays as the configuration's body model gives them (benchmark/inputs.py):
v_template (V, 3), shapedirs (V, 3, NB), posedirs (207, 3V), j_regressor
(24, V), lbs_weights (V, 24), extra_joint_vertex_ids (21,) and the extra,
cocoplus and h36m regressors.  The output joints are the 24 kinematic joints,
then 21 vertex landmarks and 9 + 19 + 17 regressed joints, 90 in all.
"""

import torch

SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21)


def _mat3mul(a, b):
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def _mat3vec(a, v):
    return torch.sum(a * v[..., None, :], dim=-1)


def landmark_regressor(smpl) -> torch.Tensor:
    """(66, V): one-hot rows of the 21 landmark vertices, then the extra,
    cocoplus and h36m regressors."""
    v = smpl["v_template"].shape[0]
    onehot = torch.zeros((21, v), dtype=smpl["v_template"].dtype, device=smpl["v_template"].device)
    onehot[torch.arange(21), smpl["extra_joint_vertex_ids"]] = 1.0
    return torch.cat([onehot, smpl["j_regressor_extra"], smpl["j_regressor_cocoplus"], smpl["j_regressor_h36m"]])


def smpl_forward(smpl, betas, body_pose, global_orient, block: int = 800):
    """(vertices (B, V, 3), joints (B, 90, 3)) for betas (B, NB), body_pose
    (B, 23, 3, 3) and global_orient (B, 3, 3), computed block rows at a time."""
    verts, joints = [], []
    reg = landmark_regressor(smpl)
    for s in range(0, betas.shape[0], block):
        v, j = _smpl_block(smpl, reg, betas[s:s + block], body_pose[s:s + block], global_orient[s:s + block])
        verts.append(v)
        joints.append(j)
    return torch.cat(verts), torch.cat(joints)


def _smpl_block(smpl, reg, betas, body_pose, global_orient):
    b = betas.shape[0]
    vt, sd, pd = smpl["v_template"], smpl["shapedirs"], smpl["posedirs"]
    nv = vt.shape[0]
    rot = torch.cat([global_orient[:, None], body_pose], dim=1)  # (B, 24, 3, 3)
    j_template = smpl["j_regressor"] @ vt
    j_shapedirs = torch.einsum("jv,vcl->jcl", smpl["j_regressor"], sd)
    joints_rest = j_template + torch.einsum("bl,jcl->bjc", betas, j_shapedirs)
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    pose_feature = (rot[:, 1:] - eye).reshape(b, -1)

    world_r, world_t = [rot[:, 0]], [joints_rest[:, 0]]
    for j in range(1, 24):
        p = SMPL_PARENTS[j]
        world_r.append(_mat3mul(world_r[p], rot[:, j]))
        world_t.append(_mat3vec(world_r[p], joints_rest[:, j] - joints_rest[:, p]) + world_t[p])
    world_r = torch.stack(world_r, dim=1)
    posed_joints = torch.stack(world_t, dim=1)
    rel_t = posed_joints - _mat3vec(world_r, joints_rest)
    a12 = torch.cat([world_r.reshape(b, 24, 9), rel_t], dim=-1)  # (B, 24, 12)

    # template + shape and pose blend shapes, channel-major (B, 3, V)
    v_posed = (vt.T + torch.einsum("bl,vcl->bcv", betas, sd)
               + torch.matmul(pose_feature, pd).reshape(b, nv, 3).transpose(1, 2))
    t12 = torch.einsum("vj,bjr->brv", smpl["lbs_weights"], a12)
    verts_cm = torch.stack([t12[:, 3 * i] * v_posed[:, 0] + t12[:, 3 * i + 1] * v_posed[:, 1]
                            + t12[:, 3 * i + 2] * v_posed[:, 2] + t12[:, 9 + i] for i in range(3)], dim=1)
    regressed = torch.einsum("jv,bcv->bjc", reg, verts_cm)
    return verts_cm.transpose(1, 2), torch.cat([posed_joints, regressed], dim=1)


def vertex_uncertainty(verts_samples):
    """(avg L2 from the mean (B, V), directional std (B, V, 3)) of (B, N, V, 3)."""
    diff = verts_samples - verts_samples.mean(dim=1, keepdim=True)
    return torch.mean(torch.linalg.norm(diff, dim=-1), dim=1), torch.sqrt(torch.mean(diff ** 2, dim=1))
