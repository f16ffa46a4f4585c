"""The inputs of the BAL cells: a visibility pattern at the published
counts of a BAL problem, and scenes over it, from the configuration's
file, the traffic mix's file and their seeds.

Nothing here imports the system under test; the program receives host
NumPy arrays.  A BAL problem file holds each observation's camera, point
and image point, and a start for every camera and point.  With no problem
file at hand, the pattern keeps the file's counts exactly and draws the
rest (``assumed`` in the configuration):

* track lengths: 2 + a geometric draw (mean the file's observations over
  its points, less 2), at most the camera count, adjusted one point at a
  time until they sum to the observation count;
* each point's cameras: distinct, uniformly drawn;
* observations in camera-major order, as the camera's images list them.

A scene (one per catalog entry, one pattern for them all) puts the points
in a ball and the cameras on a ring around it, each looking at the ball's
centre (every observation has P_z < 0 in BAL's convention), draws the
intrinsics, projects with BAL's model, adds Gaussian noise, and perturbs
the truth into the start.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np

from .generate import rng

CAMERA = 9


class Pattern(NamedTuple):
    obs_cam: np.ndarray  # [N] int64
    obs_pt: np.ndarray   # [N] int64
    track: np.ndarray    # [P] observations a point


class Scene(NamedTuple):
    cams: np.ndarray   # [C, 9] the truth
    pts: np.ndarray    # [P, 3]
    uv: np.ndarray     # [N, 2] observed image points
    cams0: np.ndarray  # the start
    pts0: np.ndarray


def track_lengths(config: Dict, seed: int) -> np.ndarray:
    """``[P]`` track lengths in [track_min, C] summing to the observation
    count exactly."""
    n_pts, n_obs, n_cams = config["points"], config["observations"], config["cameras"]
    lo = config["track_min"]
    r = rng(seed, 10)
    mean_extra = n_obs / n_pts - lo
    k = np.minimum(lo + r.geometric(1.0 / (1.0 + mean_extra), size=n_pts) - 1, n_cams)
    while (gap := n_obs - int(k.sum())) != 0:
        room = np.flatnonzero(k < n_cams) if gap > 0 else np.flatnonzero(k > lo)
        pick = r.choice(room, size=min(abs(gap), room.size), replace=False)
        k[pick] += 1 if gap > 0 else -1
    return k


def pattern(config: Dict, seed: int) -> Pattern:
    """The visibility pattern of ``seed``: each point's cameras, distinct
    and uniformly drawn, in camera-major order."""
    n_pts, n_cams = config["points"], config["cameras"]
    k = track_lengths(config, seed)
    r = rng(seed, 11)
    cams = np.argsort(r.random((n_pts, n_cams)), axis=1)  # a random order of the cameras a point
    seen = np.arange(n_cams)[None, :] < k[:, None]
    obs_pt, slot = np.nonzero(seen)
    obs_cam = cams[obs_pt, slot]
    order = np.lexsort((obs_pt, obs_cam))
    return Pattern(obs_cam[order].astype(np.int64), obs_pt[order].astype(np.int64), k)


def _rotation(w: np.ndarray) -> np.ndarray:
    """Rodrigues: axis-angle ``[..., 3]`` → ``[..., 3, 3]``."""
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    k = w / np.maximum(th[..., 0], 1e-300)
    z = np.zeros(w.shape[:-1])
    K = np.stack([np.stack([z, -k[..., 2], k[..., 1]], -1),
                  np.stack([k[..., 2], z, -k[..., 0]], -1),
                  np.stack([-k[..., 1], k[..., 0], z], -1)], -2)
    return np.eye(3) + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)


def _axis_angle(R: np.ndarray) -> np.ndarray:
    """The axis-angle vector of one rotation matrix (through its unit
    quaternion, the largest component first)."""
    t = np.trace(R)
    i = int(np.argmax([t, R[0, 0], R[1, 1], R[2, 2]]))
    v = np.zeros(3)
    if i == 0:
        w = 0.5 * math.sqrt(1.0 + t)
        v[:] = [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
        v /= 4.0 * w
    else:
        a = i - 1
        b, c = (a + 1) % 3, (a + 2) % 3
        v[a] = 0.5 * math.sqrt(1.0 + 2.0 * R[a, a] - t)
        w = (R[c, b] - R[b, c]) / (4.0 * v[a])
        v[b] = (R[a, b] + R[b, a]) / (4.0 * v[a])
        v[c] = (R[a, c] + R[c, a]) / (4.0 * v[a])
    if w < 0:
        w, v = -w, -v
    s = float(np.linalg.norm(v))
    return v * (2.0 * math.atan2(s, w) / s) if s > 1e-15 else 2.0 * v


def project(cams: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """BAL's model, float64: ``[N, 2]`` image points of ``pts [N, 3]`` in
    ``cams [N, 9]``."""
    P = (_rotation(cams[:, :3]) @ pts[:, :, None])[:, :, 0] + cams[:, 3:6]
    p = -P[:, :2] / P[:, 2:3]
    r2 = (p * p).sum(1, keepdims=True)
    return cams[:, 6:7] * (1.0 + cams[:, 7:8] * r2 + cams[:, 8:9] * r2 * r2) * p


def scene(config: Dict, pat: Pattern, seed: int, index: int) -> Scene:
    """Scene ``index`` of the catalog of ``seed`` over the pattern ``pat``."""
    n_pts, n_cams = config["points"], config["cameras"]
    sc, intr, start = config["scene"], config["intrinsics"], config["start"]
    r = rng(seed, 100 + index)
    radius = sc["points_radius"]
    d = r.normal(size=(n_pts, 3))
    pts = radius * d / np.linalg.norm(d, axis=1, keepdims=True) * r.random((n_pts, 1)) ** (1 / 3)
    cams = np.zeros((n_cams, CAMERA))
    angle = 2.0 * math.pi * (np.arange(n_cams) + r.uniform(-0.25, 0.25, n_cams)) / n_cams
    for c in range(n_cams):
        centre = np.array([sc["ring_radius"] * math.cos(angle[c]),
                           sc["ring_radius"] * math.sin(angle[c]),
                           r.uniform(-1.0, 1.0) * sc["ring_height"]])
        z = centre / np.linalg.norm(centre)  # camera +z away from the scene: it looks down -z
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        cams[c, :3] = _axis_angle(R)
        cams[c, 3:6] = -R @ centre
    cams[:, 6] = r.uniform(*intr["focal_px"], n_cams)
    cams[:, 7] = r.normal(0.0, intr["k1_sd"], n_cams)
    cams[:, 8] = r.normal(0.0, intr["k2_sd"], n_cams)
    uv = project(cams[pat.obs_cam], pts[pat.obs_pt])
    uv = uv + config["noise_px"] * r.normal(size=uv.shape)
    cams0 = cams.copy()
    cams0[:, :3] += start["rotation_rad"] / math.sqrt(3.0) * r.normal(size=(n_cams, 3))
    cams0[:, 3:6] += start["translation_frac"] * radius / math.sqrt(3.0) * r.normal(size=(n_cams, 3))
    cams0[:, 6] *= 1.0 + start["focal_frac"] * r.normal(size=n_cams)
    pts0 = pts + start["points_frac"] * radius / math.sqrt(3.0) * r.normal(size=pts.shape)
    return Scene(cams, pts, uv, cams0, pts0)


def catalog(config: Dict, mix: Dict):
    """(the pattern, the mix's ``catalog_calls`` scenes over it), all from
    the mix's ``catalog_seed``."""
    pat = pattern(config, mix["catalog_seed"])
    return pat, [scene(config, pat, mix["catalog_seed"], i) for i in range(mix["catalog_calls"])]
