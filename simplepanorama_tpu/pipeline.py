"""Pipeline driver: the `Panorama` class.

Library API shaped like the reference's headless path
(/root/reference/src/main.cpp:43-66 and pan::panorama,
/root/reference/src/classes/_panorama.cpp:440-537): construct with image
paths, `stitch(config)`, then `get_preview()` / `get_panorama(roi)`.
Progress is reported through a callback (the reference's atomic fraction
protocol, _gtk_vars.h:17-58) and cancellation through a token polled at
stage boundaries (_panorama.cpp:357-361).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import numpy as np

from simplepanorama_tpu.config import Config


class StitchCancelled(RuntimeError):
    """Raised when the cancellation token is set mid-stitch."""


class CancelToken:
    """Cross-thread cancellation flag (reference: std::atomic<bool>
    cancel_var, _panorama.h:200)."""

    def __init__(self) -> None:
        self._ev = threading.Event()

    def cancel(self) -> None:
        self._ev.set()

    def cancelled(self) -> bool:
        return self._ev.is_set()

    def check(self) -> None:
        if self._ev.is_set():
            raise StitchCancelled("stitching cancelled")


class Progress:
    """Stage-weighted fractional progress (reference protocol: keypoints 1/6,
    matching 1/6, BA 1/3, seams ~1/3 — see SURVEY §5)."""

    def __init__(self, callback: Optional[Callable[[float, str], None]] = None):
        self._cb = callback
        self.fraction = 0.0
        self.text = ""

    def add(self, delta: float, text: Optional[str] = None) -> None:
        self.fraction = min(1.0, self.fraction + delta)
        if text is not None:
            self.text = text
        if self._cb:
            self._cb(self.fraction, self.text)

    def set(self, value: float, text: Optional[str] = None) -> None:
        self.fraction = value
        if text is not None:
            self.text = text
        if self._cb:
            self._cb(self.fraction, self.text)


class Panorama:
    """Full pipeline driver. See `stitch()`."""

    def __init__(self, paths: Sequence[str],
                 progress: Optional[Callable[[float, str], None]] = None):
        from simplepanorama_tpu.io import ImageSet
        self.images = ImageSet(paths)
        self.progress = Progress(progress)
        self.cancel_token = CancelToken()
        self.result = None           # stitch_result equivalent
        self.stitch_params = None    # post-BA compositing state
        self.config: Optional[Config] = None
        self._full_pano: Optional[np.ndarray] = None
        # (params, thread, result-dict, cancel-event) of the in-flight
        # background full-res prefetch; see _start_full_prefetch
        self._full_prefetch = None
        self.connected = (0, 0)      # (n_connected, n_total)

    def cancel(self) -> None:
        self.cancel_token.cancel()

    def _start_full_prefetch(self) -> None:
        """Decode the full-res connected images and upload the packed
        source stack in the background, overlapping preview compositing
        (the sources depend only on the stitch result, never on blend/
        projection settings — see fullres.prefetch_sources). get_panorama
        then starts with device-resident sources instead of paying
        decode + upload on its critical path."""
        from simplepanorama_tpu.render.fullres import prefetch_sources
        params, images = self.stitch_params, self.images
        if params is None:
            return
        # cancel any stale in-flight prefetch before starting another so
        # two decodes never run concurrently (transient 2x host RAM/HBM)
        if self._full_prefetch is not None:
            self._full_prefetch[3].set()
        res = params.res
        connected = [False] * len(images.loaded)
        for g in res.nodes:
            connected[g] = True
        threads = self.config.threads if self.config else 4
        out: dict = {}
        cancel = threading.Event()

        def work():
            try:
                full = images.load_connected_images(connected, threads)
                if cancel.is_set():
                    return
                comp_full = [full[g] for g in res.nodes]
                out["full"] = comp_full
                if cancel.is_set():
                    return
                out["stack"] = prefetch_sources(params, comp_full)
            except Exception as e:  # fall back to the synchronous path
                import logging
                logging.getLogger(__name__).debug(
                    "full-res prefetch failed (synchronous fallback): %s",
                    e)
                out.pop("stack", None)

        # not a daemon: interpreter exit waits for the upload instead of
        # killing the thread inside the device runtime, which aborts the
        # process on the GPU
        t = threading.Thread(target=work)
        t.start()
        self._full_prefetch = (params, t, out, cancel)

    # Full implementation lands with the end-to-end milestone; see
    # simplepanorama_tpu/stitcher.py for the staged pipeline functions.
    def stitch(self, config: Optional[Config] = None) -> "Panorama":
        from simplepanorama_tpu import stitcher
        self.config = config or Config()
        self.result, self.stitch_params, self.connected = stitcher.run_pipeline(
            self.images, self.config, self.progress, self.cancel_token)
        self._full_pano = None
        if self.stitch_params is not None:
            self._start_full_prefetch()
        return self

    def save_state(self, path) -> None:
        """Checkpoint the post-BA stitch state (rot/K/adjacency/order) so
        compositing can later resume — with any blend/projection/seam
        settings — without re-running features, matching, or BA
        (SURVEY §5 checkpoint/resume; the BA result is the expensive,
        settings-independent part of the pipeline)."""
        from simplepanorama_tpu.utils.checkpoint import save_stitch_state
        if self.result is None:
            raise RuntimeError("stitch() has not been run")
        save_stitch_state(path, self.result, paths=self.images.loaded)

    @classmethod
    def from_state(cls, path, paths: Optional[Sequence[str]] = None,
                   config: Optional[Config] = None,
                   progress: Optional[Callable[[float, str], None]] = None,
                   ) -> "Panorama":
        """Resume from a checkpoint written by save_state: reload the
        images at init_size, rebuild the compositing state under
        ``config``, and return a Panorama ready for get_preview() /
        get_panorama() — features/matching/BA are skipped entirely.
        ``paths`` overrides the image list recorded in the checkpoint
        (same order as at save time; res.nodes indexes into it)."""
        from simplepanorama_tpu.utils.checkpoint import load_stitch_state
        res, saved_paths = load_stitch_state(path, with_paths=True)
        if paths is None:
            paths = saved_paths
        if not paths:
            raise RuntimeError("checkpoint has no image list; pass paths=")
        p = cls(paths, progress)
        p.result = res
        p.set_config(config or Config())
        return p

    def set_config(self, config: Config) -> "Panorama":
        """Re-run compositing only (stitch_parameters::set_config,
        _panorama.cpp:75-158) against the existing BA result — changing
        blend/projection/seam settings never re-runs features/match/BA."""
        from simplepanorama_tpu import stitcher
        if self.result is None:
            raise RuntimeError("no stitch state (run stitch() or from_state)")
        self.config = config
        if not self.images.img_data:
            self.images.load_resized(config.init_size, config.threads)
        comp_imgs = [self.images.img_data[g] for g in self.result.nodes]
        self.stitch_params = stitcher.set_config(self.result, comp_imgs,
                                                 config)
        self.connected = (len(self.result.nodes), len(self.images.img_data))
        self._full_pano = None
        if self._full_prefetch is None or \
                self._full_prefetch[0].res is not self.result:
            self._start_full_prefetch()
        return self

    def get_preview(self) -> np.ndarray:
        from simplepanorama_tpu import stitcher
        if self.stitch_params is None:
            raise RuntimeError("stitch() has not been run")
        return stitcher.render_preview(self.stitch_params, self.config)

    def get_panorama(self, roi=None) -> np.ndarray:
        """Full-resolution render (re-projects and re-blends only — BA ran at
        init_size; _panorama.cpp:259-354). `roi` is (x, y, w, h) in preview
        coordinates, rescaled like _panorama.cpp:547-569."""
        from simplepanorama_tpu import stitcher
        if self.stitch_params is None:
            raise RuntimeError("stitch() has not been run")
        if self._full_pano is None:
            pre = self._full_prefetch
            if pre is not None and pre[0].res is self.stitch_params.res:
                _, t, out, _cancel = pre
                t.join()
                if "full" in out:
                    self._full_pano = stitcher.render_full(
                        self.stitch_params, self.config, out["full"],
                        src_stack=out.get("stack"))
                # release the prefetched host images + device stack
                # (m*Hs*Ws*3 bytes of HBM) now that the render consumed
                # them — the cached _full_pano serves later calls
                out.clear()
                self._full_prefetch = None
            if self._full_pano is None:
                self._full_pano = stitcher.render_full_from_imageset(
                    self.stitch_params, self.config, self.images)
        if roi is None:
            return self._full_pano
        preview = self.get_preview()
        fh, fw = self._full_pano.shape[:2]
        ph, pw = preview.shape[:2]
        sx, sy = fw / pw, fh / ph
        x, y, w, h = roi
        x0 = max(0, int(x * sx)); y0 = max(0, int(y * sy))
        x1 = min(fw, int((x + w) * sx)); y1 = min(fh, int((y + h) * sy))
        return self._full_pano[y0:y1, x0:x1]


def diagnose(paths, config: Optional[Config] = None) -> dict:
    """Single-threaded inspection run (panorama::test,
    /root/reference/src/classes/_panorama.cpp:572-609): load -> keypoints ->
    match -> adjacency, returning the intermediate tables for debugging."""
    from simplepanorama_tpu.io import ImageSet
    from simplepanorama_tpu.features import extract_features
    from simplepanorama_tpu.adjacency import build_adjacency
    from simplepanorama_tpu.geometry.graph import connected_components
    from simplepanorama_tpu.geometry.focal import focal_from_hom

    cfg = config or Config()
    images = ImageSet(paths)
    images.load_resized(cfg.init_size, threads=1)
    feats = extract_features(images.img_data, cfg)
    sizes = [im.shape[:2] for im in images.img_data]
    adjres = build_adjacency(feats, sizes, cfg)
    comps = connected_components(adjres.adj)
    focal = focal_from_hom(adjres.hom_mat, adjres.adj)
    return {
        "n_images": len(images.img_data),
        "keypoint_counts": [f.count for f in feats],
        "raw_match_counts": adjres.raw_counts,
        "adjacency": adjres.adj,
        "hom_mat": adjres.hom_mat,
        "components": [c.nodes for c in comps],
        "focal_estimate": focal,
    }
