"""Test configuration: run JAX on a virtual 8-device CPU mesh so sharding
code paths execute without accelerator hardware (the 'fake backend' the
reference lacks — SURVEY §4). The program itself runs on the GPU through
chip_smoke.py."""

import os

# must be set before jax is imported anywhere; the environment may point
# JAX at a real accelerator — tests always run on the virtual CPU mesh
# unless SPT_TEST_PLATFORM overrides.
_platform = os.environ.get("SPT_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _platform
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# jax.config is the authoritative override should a backend already be
# registered before the env var is consulted.
import jax  # noqa: E402

jax.config.update("jax_platforms", _platform)

import numpy as np
import pytest

REFERENCE = "/root/reference"


@pytest.fixture(scope="session")
def map_images():
    """The 6-image 'map' sequence at working resolution (700 px max side)."""
    import glob
    import cv2
    from simplepanorama_tpu.io import clamp_to_init_size
    paths = sorted(glob.glob(f"{REFERENCE}/results/map/budapest*.jpg"))
    imgs = [clamp_to_init_size(cv2.imread(p), 700) for p in paths]
    return paths, imgs


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def _stitch_once(pattern, init_size, ransac=500):
    import glob
    from simplepanorama_tpu import Panorama, Config
    cfg = Config()
    cfg.init_size = init_size
    cfg.RANSAC_iterations = ransac
    p = Panorama(sorted(glob.glob(pattern)))
    p.stitch(cfg)
    return p


@pytest.fixture(scope="session")
def map_stitched():
    """map stitched once per session (init 400, RANSAC 500, defaults).
    Tests needing a different COMPOSITING config must reuse only
    `.result` via `reuse_stitch` — never mutate this object."""
    return _stitch_once(f"{REFERENCE}/results/map/budapest*.jpg", 400)


@pytest.fixture(scope="session")
def fkh_stitched():
    """FKH360 stitched once per session (init 300, RANSAC 500,
    defaults). Same reuse rules as map_stitched."""
    return _stitch_once(f"{REFERENCE}/results/FKH360/resized*.jpg", 300)


def reuse_stitch(pano, cfg):
    """New Panorama sharing ``pano``'s images + BA result, composited
    under ``cfg`` — the public set_config/from_state contract (features/
    matching/BA are settings-independent), used to keep the golden tier
    inside a CI window."""
    from simplepanorama_tpu import Panorama
    p2 = Panorama(list(pano.images.f_list))
    p2.images = pano.images
    p2.result = pano.result
    p2.set_config(cfg)
    return p2


def ncc_aligned(out, ref_path, max_vshift=0.25, circular=False):
    """NCC of a panorama vs a golden JPG, aspect-preserving: the reference
    outputs are hand-cropped, so resize the golden to the output's width
    and search the vertical offset (and, for 360 panoramas, the circular
    horizontal shift — the u-origin is a free gauge) that maximizes NCC
    of the central band."""
    import cv2
    ref = cv2.imread(ref_path)
    h, w = out.shape[:2]
    rh = int(ref.shape[0] * w / ref.shape[1])
    ref = cv2.resize(ref, (w, rh), interpolation=cv2.INTER_AREA)
    a = cv2.cvtColor(out, cv2.COLOR_BGR2GRAY).astype(np.float32)
    b = cv2.cvtColor(ref, cv2.COLOR_BGR2GRAY).astype(np.float32)
    best = -1.0
    H = min(h, rh)
    core = slice(int(H * 0.15), int(H * 0.85))

    def norm(x):
        return (x - x.mean()) / (x.std() + 1e-6)

    for dv in range(-int(max_vshift * H), int(max_vshift * H) + 1, 2):
        a0 = a[max(0, dv):max(0, dv) + H, :]
        b0 = b[max(0, -dv):max(0, -dv) + H, :]
        m = min(a0.shape[0], b0.shape[0])
        a1, b1 = norm(a0[:m][core]), norm(b0[:m][core])
        if a1.size < 1000:
            continue
        if circular:
            F = np.fft.rfft(a1, axis=1) * np.conj(np.fft.rfft(b1, axis=1))
            corr = np.fft.irfft(F, n=a1.shape[1], axis=1).sum(0) / a1.size
            v = corr.max()
        else:
            v = (a1 * b1).mean()
        best = max(best, float(v))
    log = os.environ.get("SPT_LOG_NCC")
    if log:   # gate calibration: record measured scores per golden
        with open(log, "a") as f:
            f.write(f"{ref_path} {best:.4f}\n")
    return best
