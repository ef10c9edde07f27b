"""Seeded synthetic BraTS and Pancreas volumes of the reference's accuracy
bench (``bench.py:_synth_brats_volume``, ``_synth_pancreas_volume``):
numpy only.

The arithmetic and the order of the draws from the ``np.random.Generator``
are the reference's, so one generator state gives the reference's
volumes bit for bit (``tests/test_torch_accuracy.py``); every Dice of
``cli/accuracy.py`` rests on that.

BraTS: 4 modalities (t1ce, t1, flair, t2) over an ellipsoid brain with
1-3 warped lesion foci, each an NCR core, an ET rim and ED outside, the
classes told apart only by cross-modality signatures under noise and
smooth bias fields. Labels {0, 1, 2, 3} (3 = enhancing; scoring maps it
to 4). Pancreas: one CT channel over a body oval with a curved tube of
varying radius at low contrast. Labels {0, 1}. Shapes are (X, Y, Z);
modalities come out as (C, X, Y, Z) f32, labels as (X, Y, Z) int32.
"""
from __future__ import annotations

import numpy as np

# additive class signatures in z-scored units, modality order (t1ce, t1,
# flair, t2): ED bright on flair/t2 only, ET bright on t1ce only, NCR
# dark on t1ce and moderately bright on t2
_CLASS_SIGNATURES = {
    2: (0.1, -0.2, 1.0, 0.9),    # ED
    1: (-0.8, -0.4, 0.3, 0.6),   # NCR
    3: (1.1, 0.2, 0.5, 0.4),     # ET
}
_NOISE_SIGMA = 0.55


def _grids(shape):
    x, y, z = shape
    return np.meshgrid(
        np.arange(x, dtype=np.float32),
        np.arange(y, dtype=np.float32),
        np.arange(z, dtype=np.float32),
        indexing="ij",
    )


def smooth_field(rng, grids, wavelength, n_waves=4):
    """Smooth random field of unit std: a sum of ``n_waves`` cosines of
    random direction, wavelength and phase."""
    xx, yy, zz = grids
    out = np.zeros(xx.shape, np.float32)
    for _ in range(n_waves):
        k = rng.standard_normal(3)
        k *= 2.0 * np.pi / (wavelength * rng.uniform(0.7, 1.5)) / (
            np.linalg.norm(k) + 1e-9
        )
        phase = rng.uniform(0, 2 * np.pi)
        out += np.cos(k[0] * xx + k[1] * yy + k[2] * zz + phase)
    return out * np.sqrt(2.0 / n_waves)


def synth_brats_volume(rng, shape, r_div=10):
    """One BraTS-like case: ((4, X, Y, Z) f32 modalities, (X, Y, Z) int32
    labels in {0, 1, 2, 3}). Lesion semi-axes are ~2 min(X, Y) / r_div."""
    x, y, z = shape
    xx, yy, zz = grids = _grids(shape)
    # brain: jittered ellipsoid
    ax_ = 0.42 * x * rng.uniform(0.92, 1.05)
    ay = 0.42 * y * rng.uniform(0.92, 1.05)
    az = 0.44 * z * rng.uniform(0.92, 1.05)
    brain = (
        ((xx - x / 2) / ax_) ** 2
        + ((yy - y / 2) / ay) ** 2
        + ((zz - z / 2) / az) ** 2
    ) < 1.0

    seg = np.zeros(shape, np.int32)
    prio = np.array([0, 3, 1, 2])          # NCR > ET > ED > bg precedence
    r0 = min(x, y) / r_div
    n_foci = int(rng.integers(1, 4))
    for f in range(n_foci):
        scale = 1.0 if f == 0 else rng.uniform(0.45, 0.7)
        axes = 2.0 * r0 * scale * rng.uniform(0.7, 1.1, size=3)
        rot = np.linalg.qr(rng.standard_normal((3, 3)))[0].astype(np.float32)
        # focus centre inside the central brain region
        fx = x / 2 + rng.uniform(-0.22, 0.22) * x
        fy = y / 2 + rng.uniform(-0.22, 0.22) * y
        fz = z / 2 + rng.uniform(-0.2, 0.2) * z
        dxs = np.stack(
            [xx - fx, yy - fy, zz - fz], axis=0
        ).reshape(3, -1)
        local = (rot / axes[:, None]).astype(np.float32) @ dxs
        d = np.sqrt((local * local).sum(0)).reshape(shape)
        rho = 1.0 + 0.22 * smooth_field(rng, grids, wavelength=2.5 * r0)
        d = d / np.maximum(rho, 0.4)
        et_out = rng.uniform(0.62, 0.82)
        ncr_out = et_out * rng.uniform(0.45, 0.7)
        seg_f = np.where(d < ncr_out, 1, np.where(d < et_out, 3, 2))
        take = (d < 1.0) & brain & (prio[seg_f] > prio[seg])
        seg[take] = seg_f[take]

    mods = np.empty((4,) + tuple(shape), np.float32)
    gain = rng.uniform(0.9, 1.1, size=4)   # per-case per-modality gain
    for m in range(4):
        bias = 0.3 * smooth_field(rng, grids, wavelength=min(x, y) / 2.0)
        v = 1.0 + bias + _NOISE_SIGMA * rng.standard_normal(shape).astype(
            np.float32
        )
        for lab, sig in _CLASS_SIGNATURES.items():
            v[seg == lab] += sig[m]
        mods[m] = v * gain[m]
    mods[:, ~brain] = 0.0
    seg[~brain] = 0
    return mods, seg


def synth_pancreas_volume(rng, shape):
    """One abdominal-CT-like case: ((1, X, Y, Z) f32, (X, Y, Z) int32
    labels in {0, 1}): a tube swept along a curved centreline of 24
    samples, +0.7 on sigma-0.55 noise."""
    x, y, z = shape
    xx, yy, zz = grids = _grids(shape)
    body = (
        ((xx - x / 2) / (0.46 * x)) ** 2 + ((yy - y / 2) / (0.4 * y)) ** 2
    ) < 1.0

    # centreline: head -> tail across ~40 % of X, a sinusoidal bend in Y
    # and a slight drift in Z
    t = np.linspace(0.0, 1.0, 24, dtype=np.float32)
    L = 0.38 * x * rng.uniform(0.85, 1.15)
    cx = x / 2 + rng.uniform(-0.08, 0.08) * x
    cy = y / 2 + rng.uniform(-0.08, 0.08) * y
    cz = z / 2 + rng.uniform(-0.12, 0.12) * z
    bend = rng.uniform(0.05, 0.11) * y
    phase = rng.uniform(0, np.pi)
    px = cx + L * (t - 0.5)
    py = cy + bend * np.sin(np.pi * t + phase)
    pz = cz + rng.uniform(-0.05, 0.05) * z * (t - 0.5)
    # the head (t = 0) thicker than the tail, radius jittered a sample
    r_head = 0.055 * min(x, y) * rng.uniform(0.85, 1.2)
    radius = r_head * (1.15 - 0.55 * t) * rng.uniform(0.85, 1.15, t.shape)

    # signed distance to the sweep: the least over the centreline samples
    # of the distance to the sample less its radius
    sdf = np.full(shape, np.inf, np.float32)
    for i in range(len(t)):
        d = np.sqrt(
            (xx - px[i]) ** 2 + (yy - py[i]) ** 2 + (zz - pz[i]) ** 2
        )
        sdf = np.minimum(sdf, d - radius[i])
    warp = 0.18 * r_head * smooth_field(rng, grids, wavelength=3.0 * r_head)
    seg = ((sdf + warp) < 0) & body
    seg = seg.astype(np.int32)

    bias = 0.3 * smooth_field(rng, grids, wavelength=min(x, y) / 2.0)
    ct = 1.0 + bias + _NOISE_SIGMA * rng.standard_normal(shape).astype(
        np.float32
    )
    ct[seg == 1] += 0.7
    ct *= rng.uniform(0.9, 1.1)
    ct[~body] = 0.0
    return ct[None].astype(np.float32), seg
