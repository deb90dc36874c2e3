"""The five synthetic shape classes and the random rotation that
train_cgf_embedding.py draws its correspondences from (the port's copy of
the JAX package's tests/shapes.py generators: the same numpy draws, so a
seed gives the same clouds)."""

import numpy as np


def ellipsoid(rng, n=1500, a=1.3, b=0.8, c=0.5):
    # NOTE: a plain sphere is pathological for LRF-based descriptors
    # (isotropic neighborhoods -> degenerate frames), like it would be for
    # the reference; an ellipsoid keeps frames well-defined.
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (v * np.array([a, b, c])).astype(np.float32)


def box(rng, n=1500, a=1.4, b=0.9, c=0.5):
    # sample on the surface of a box
    pts = []
    areas = np.array([b * c, a * c, a * b])
    probs = areas / areas.sum()
    for _ in range(n):
        axis = rng.choice(3, p=probs)
        sign = rng.choice([-1.0, 1.0])
        p = rng.uniform(-0.5, 0.5, 3) * np.array([a, b, c])
        p[axis] = sign * [a, b, c][axis] / 2
        pts.append(p)
    return np.array(pts, np.float32)


def torus(rng, n=1500, R=1.0, r=0.35):
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    x = (R + r * np.cos(v)) * np.cos(u)
    y = (R + r * np.cos(v)) * np.sin(u)
    z = r * np.sin(v)
    return np.stack([x, y, z], 1).astype(np.float32)


def cylinder(rng, n=1500, r=0.5, h=1.6):
    u = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-h / 2, h / 2, n)
    # caps
    cap = rng.random(n) < 0.25
    rr = np.where(cap, np.sqrt(rng.random(n)) * r, r)
    z = np.where(cap, np.sign(z) * h / 2, z)
    return np.stack([rr * np.cos(u), rr * np.sin(u), z], 1).astype(np.float32)


def cone(rng, n=1500, r=0.8, h=1.5):
    t = np.sqrt(rng.random(n))  # area-uniform along the slant
    u = rng.uniform(0, 2 * np.pi, n)
    base = rng.random(n) < 0.3
    rr = np.where(base, np.sqrt(rng.random(n)) * r, t * r)
    z = np.where(base, 0.0, h * (1 - t))
    pts = np.stack([rr * np.cos(u), rr * np.sin(u), z], 1)
    return (pts - pts.mean(0)).astype(np.float32)


SHAPES = [ellipsoid, box, torus, cylinder, cone]


def random_rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)
