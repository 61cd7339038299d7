"""simplepanorama_tpu — a JAX panorama-stitching framework.

A from-scratch JAX/XLA reimplementation of the full pipeline of
SimplePanorama (Brown & Lowe, "Automatic Panoramic Image Stitching using
Invariant Features", IJCV 2007, plus the reference's deliberate changes:
rootSIFT, overlap-aware match verification, a relaxed bundle-adjustment
objective, graph-cut seams, cylindrical/stereographic projections with a
missing-center fix, exposure-disparity fix, and auto-straightening).

Design:
  * every numeric kernel is a fixed-shape JAX program (vmapped/batched,
    matmuls for descriptor matching, batched RANSAC),
  * bundle adjustment is a jitted Levenberg-Marquardt step with a
    Schur-complement solve whose normal-equation accumulations are
    segment-sums (psum-reducible across a device mesh),
  * compositing (warp/seam/blend) is expressed as gathers and separable
    convolutions over a tiled panorama canvas,
  * distribution uses jax.sharding Meshes and XLA collectives, not threads.

The capability surface mirrors the reference (see SURVEY.md): a library API
shaped like the reference's headless path (/root/reference/src/main.cpp:43-66),
a CLI, config-file round-tripping, progress/cancellation, preview + full-res
rendering, and crop/save.
"""

import os as _os
import pathlib as _pathlib


def compile_cache_dir() -> str:
    """Directory of JAX's persistent compilation cache:
    ``$JAX_COMPILATION_CACHE_DIR`` when it is set and non-empty, else
    ``.jax_cache`` at the root of the checkout. The path is part of the
    cache key, so it must not move between runs."""
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return str(_pathlib.Path(__file__).resolve().parent.parent
               / ".jax_cache")


def _enable_compile_cache() -> None:
    import jax as _jax
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_enable_compile_cache()

from simplepanorama_tpu.config import (
    Blending,
    Projection,
    Stretch,
    Config,
    read_config_file,
    write_config_file,
)
from simplepanorama_tpu.pipeline import Panorama, StitchCancelled
from simplepanorama_tpu.viewer import PanoramaViewer

__version__ = "0.1.0"

__all__ = [
    "compile_cache_dir",
    "Blending",
    "Projection",
    "Stretch",
    "Config",
    "read_config_file",
    "write_config_file",
    "Panorama",
    "PanoramaViewer",
    "StitchCancelled",
]
