"""Test harness.

CPU tests run on a virtual 8-device CPU mesh (multi-device shardings are
validated the JAX way, SURVEY.md §4).  Tests marked `gpu` need an NVIDIA
GPU: they take the `gpu` fixture, skip elsewhere, and run on the card with
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/` (chip_smoke.py's
phase e runs them in its own process).
"""
import jax

if not (jax.config.jax_platforms or "").startswith("cuda"):
    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_num_cpu_devices", 8)
    except RuntimeError:
        pass  # backend already up: pytest.main inside a running process
# The CLI entry points turn the persistent compilation cache on; JAX writes
# its entries without a lock, so concurrent test workers sharing the one
# cache directory could read each other's half-written files.
jax.config.update("jax_enable_compilation_cache", False)
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables between test modules.

    The full suite accumulates hundreds of live CPU executables across the
    8 virtual devices; past ~145 tests XLA:CPU deterministically segfaults
    inside a later compile (jax 0.9 era; crash reproduced in
    backend_compile_and_load with and without the persistent cache).
    Clearing per module keeps the live-executable count bounded and costs
    only intra-module recompiles.
    """
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is an NVIDIA GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


def make_scene(rng, n_cams=6, n_pts=200, focal=1000.0, noise_px=0.0,
               k1=0.0, k2=0.0, spread=2.0, depth=8.0):
    """Synthetic scene generator: cameras on an arc looking at a point cloud.

    Returns dict of numpy arrays: poses (C,6) [aa,t], intrs (C,3) [f,k1,k2],
    points (P,3), obs (C,P,2) centered pixels, vis (C,P) bool.
    The recipe mirrors the reference's own synthetic-noise setup
    (optimizer.cc:155-232 Normalize/Perturb).
    """
    from metricsfm_tpu.ops import lie, projection
    import jax.numpy as jnp

    pts = rng.uniform(-spread, spread, size=(n_pts, 3))
    pts[:, 2] += depth

    poses = []
    intrs = []
    for i in range(n_cams):
        ang = (i - n_cams / 2) * 0.08
        # camera orbiting around scene center, looking roughly at it; the
        # per-camera target jitter keeps optical axes skew (cameras that
        # fixate one common point are a degenerate config for focal-from-F)
        c = np.array([np.sin(ang) * depth, 0.3 * np.sin(2 * ang), depth - np.cos(ang) * depth])
        target = np.array([0.0, 0.0, depth]) + rng.normal(0, 0.4, size=3)
        z = target - c
        z = z / np.linalg.norm(z)
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z], axis=0)  # world->cam rows
        t = -R @ c
        aa = np.asarray(lie.matrix_to_angle_axis(jnp.asarray(R)))
        poses.append(np.concatenate([aa, t]))
        intrs.append([focal, k1, k2])
    poses = np.asarray(poses)
    intrs = np.asarray(intrs, dtype=np.float64)

    uv, z = jax.vmap(lambda p, i: projection.project(p, i, jnp.asarray(pts)))(
        jnp.asarray(poses), jnp.asarray(intrs))
    uv = np.asarray(uv)
    z = np.asarray(z)
    if noise_px > 0:
        uv = uv + rng.normal(0, noise_px, size=uv.shape)
    vis = z > 0
    return {"poses": poses, "intrs": intrs, "points": pts, "obs": uv, "vis": vis}


@pytest.fixture
def scene(rng):
    return make_scene(rng)
