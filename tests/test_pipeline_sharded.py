"""The PIPELINE itself (not just library helpers) must be mesh-aware:
features, pair verification, and the fused incremental BA all run sharded
over the attached mesh and must reproduce the single-device result
(reference fan-outs: _image.cpp:125-149,
_panorama.cpp:385-436, _bundle_adjust_main.cpp:192-244)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from simplepanorama_tpu.parallel import mesh as mesh_mod


@pytest.fixture
def no_sharding():
    """Force the single-device pipeline path within this test."""
    mesh_mod.PIPELINE_SHARDING = False
    yield
    mesh_mod.PIPELINE_SHARDING = True


def test_lm_run_sharded_emits_collectives():
    """The sharded BA must actually compile to cross-device collectives —
    a fully-replicated fallback would silently pass parity tests."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    from simplepanorama_tpu import ba
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = mesh_mod.make_mesh(8)
    msh = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())
    rng = np.random.default_rng(0)
    M, N = 512, 4
    mi = jnp.asarray(rng.integers(0, N - 1, M).astype(np.int32))
    data = ba.BAData(
        mi=jax.device_put(mi, msh),
        mj=jax.device_put((mi + 1).astype(jnp.int32), msh),
        q=jax.device_put(jnp.asarray(
            rng.uniform(-200, 200, (M, 2)).astype(np.float32)), msh),
        t=jax.device_put(jnp.asarray(
            rng.uniform(-200, 200, (M, 2)).astype(np.float32)), msh),
        m_valid=jax.device_put(jnp.ones(M, bool), msh))
    cams = ba.CamState(
        focal=jax.device_put(jnp.full((N,), 700.0), rep),
        ppal=jax.device_put(jnp.zeros((N, 2)), rep),
        rotvec=jax.device_put(jnp.zeros((N, 3)), rep),
        b=jax.device_put(data.t, msh))
    lowered = jax.jit(
        lambda c, d, a: ba.lm_run_impl(c, d, a, 0.05, fast=False,
                                       max_iter=2)
    ).lower(cams, data, jax.device_put(jnp.ones(N, bool), rep))
    hlo = lowered.compile().as_text()
    assert "all-reduce" in hlo, "no cross-device reduction in sharded BA"


@pytest.mark.slow
def test_pipeline_sharded_matches_single_device(map_images, no_sharding):
    """Panorama.stitch on the 8-device mesh == single-device stitch:
    same connectivity, same BA cameras (up to f32 reduction-order drift),
    NCC-identical previews."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    from simplepanorama_tpu import Panorama, Config
    paths, _ = map_images
    cfg = Config()
    cfg.init_size = 300
    cfg.RANSAC_iterations = 300

    p1 = Panorama(paths[:4])
    p1.stitch(cfg)                      # PIPELINE_SHARDING disabled
    prev1 = p1.get_preview()

    mesh_mod.PIPELINE_SHARDING = True   # sharded run
    p8 = Panorama(paths[:4])
    p8.stitch(cfg)
    prev8 = p8.get_preview()

    assert p1.connected == p8.connected
    r1, r8 = p1.result, p8.result
    assert r1.nodes == r8.nodes
    np.testing.assert_allclose(r1.K[:, 0, 0], r8.K[:, 0, 0], rtol=2e-2)
    # rotations agree to a fraction of a degree
    for a, b in zip(r1.rot, r8.rot):
        ang = np.degrees(np.arccos(np.clip((np.trace(a.T @ b) - 1) / 2,
                                           -1, 1)))
        assert ang < 0.5, f"rotation drift {ang:.3f} deg"
    # previews: same canvas geometry up to a couple px, high NCC
    assert abs(prev1.shape[0] - prev8.shape[0]) <= 8
    assert abs(prev1.shape[1] - prev8.shape[1]) <= 8
    h = min(prev1.shape[0], prev8.shape[0])
    w = min(prev1.shape[1], prev8.shape[1])
    a = prev1[:h, :w].astype(np.float32).mean(-1)
    b = prev8[:h, :w].astype(np.float32).mean(-1)
    a = (a - a.mean()) / (a.std() + 1e-6)
    b = (b - b.mean()) / (b.std() + 1e-6)
    # canvas origins may differ by a few px between the two runs, which
    # depresses raw (unaligned) NCC; the tight parity gate is the camera
    # comparison above
    assert float((a * b).mean()) > 0.95
