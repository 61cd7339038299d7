"""Host-side image I/O: decode, dedup, resize rules, save.

Reproduces the behavior of ``img::images`` (/root/reference/src/classes/
_image.cpp): path dedup on add, lazy resized loading with a minimum-size
check (both sides >= 300 px) and a max-side clamp to ``init_size``
(_image.cpp:29-73), and full-res reloading of only the connected images
(_image.cpp:76-91).

Decoding runs on the host with a thread pool; the device path starts
after decode. Images are read, written and resized by OpenCV (``cv2``),
imported where it runs. Where cv2 is not installed, PNG still reads and
writes through a small zlib + numpy codec (8-bit, non-interlaced,
non-palette), so a set of PNG sources at the working size needs no
OpenCV; every other format and any resize then raise an ImportError.
Images are kept BGR uint8 (reference convention) on the host; device code
converts to float32 planes.
"""

from __future__ import annotations

import concurrent.futures
import struct
import zlib
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG color type -> samples per pixel (8-bit, non-palette types only)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class ImageTooSmallError(RuntimeError):
    """Raised for inputs under the 300-px minimum (_image.cpp:45-49)."""


def probe_size(path: str) -> Optional[tuple]:
    """Read (h, w) from the JPEG/PNG header without decoding pixels.

    Used to (a) pick a reduced-resolution decode factor and (b) compute
    the exact working-resolution output dims from the ORIGINAL dims so
    the reduced-decode fast path produces byte-identical shapes to the
    reference's full-decode-then-resize rule (_image.cpp:45-67).
    Returns None when the format is unrecognized (caller falls back to a
    full decode)."""
    try:
        with open(path, "rb") as f:
            head = f.read(32)
            if head[:8] == _PNG_SIG:
                w = int.from_bytes(head[16:20], "big")
                h = int.from_bytes(head[20:24], "big")
                return (h, w) if h > 0 and w > 0 else None
            if head[:2] != b"\xff\xd8":        # not JPEG
                return None
            f.seek(2)
            while True:
                b = f.read(1)
                if not b:
                    return None
                if b != b"\xff":
                    continue
                while b == b"\xff":
                    b = f.read(1)
                m = b[0]
                # SOF0..SOF15 except DHT(C4)/JPG(C8)/DAC(CC)
                if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
                    seg = f.read(7)
                    h = int.from_bytes(seg[3:5], "big")
                    w = int.from_bytes(seg[5:7], "big")
                    return (h, w) if h > 0 and w > 0 else None
                if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
                    continue                   # no length field
                ln = int.from_bytes(f.read(2), "big")
                f.seek(ln - 2, 1)
    except OSError:
        return None


def _cv2():
    """The cv2 module, or None where OpenCV is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _unfilter_row(ftype: int, row: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    """Undo one PNG scanline filter (PNG spec section 9.2); uint8 math
    wraps modulo 256 as the spec requires."""
    if ftype == 0:
        return row
    if ftype == 1:      # Sub: running sum along the row, per channel
        return row.reshape(-1, bpp).cumsum(axis=0, dtype=np.uint8).ravel()
    if ftype == 2:      # Up
        return row + prev
    if ftype not in (3, 4):
        raise ValueError(f"bad PNG filter type {ftype}")
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:  # Average
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        else:           # Paeth
            c = up[i - bpp] if i >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """Fallback PNG reader for hosts without cv2: decodes an 8-bit,
    non-interlaced, non-palette PNG to BGR uint8 (H, W, 3), the layout
    cv2.IMREAD_COLOR gives: gray is replicated and alpha dropped. Raises
    ValueError on anything else."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG (depth {depth}, color type "
                         f"{ctype}, interlace {interlace})")
    bpp = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * bpp + 1
    if raw.size != h * stride:
        raise ValueError("truncated PNG data")
    rows = raw.reshape(h, stride)
    px = np.empty((h, w * bpp), np.uint8)
    prev = np.zeros(w * bpp, np.uint8)
    for y in range(h):
        prev = px[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev,
                                     bpp)
    px = px.reshape(h, w, bpp)
    if bpp <= 2:
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., 2::-1])


def encode_png(img: np.ndarray) -> bytes:
    """Fallback PNG writer for hosts without cv2: lossless PNG of a BGR
    uint8 (H, W, 3) or gray (H, W) image (unfiltered scanlines, zlib
    level 6)."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"encode_png needs uint8 gray or BGR, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2
    px = img if img.ndim == 2 else img[..., ::-1]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           px.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (_PNG_SIG
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                         0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def file_to_array(path: str) -> Optional[np.ndarray]:
    """Binary read + decode (imgm::file_to_cv, _img_manipulation.cpp:148-174).

    Returns BGR uint8 (H, W, 3) or None on failure. Decodes with
    cv2.imdecode; without cv2, PNG goes through decode_png.
    """
    try:
        buf = np.fromfile(path, dtype=np.uint8)
    except OSError:
        return None
    if buf.size == 0:
        return None
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.imdecode(buf, cv2.IMREAD_COLOR)
    if buf[:8].tobytes() != _PNG_SIG:
        raise ImportError(f"decoding {path} needs OpenCV (cv2), which is "
                          f"not installed; only PNG reads without it")
    try:
        return decode_png(buf.tobytes())
    except (ValueError, zlib.error, struct.error):
        return None


def resize_keep_aspect(img: np.ndarray, desired_width: int) -> np.ndarray:
    """Resize to a target width preserving aspect ratio
    (imgm::resizeKeepAspectRatio, _img_manipulation.cpp:116-145):
    INTER_AREA when shrinking, INTER_LINEAR when enlarging."""
    import cv2
    h, w = img.shape[:2]
    scale = desired_width / w
    desired_height = int(round(h * scale))
    interp = cv2.INTER_LINEAR if desired_width > w else cv2.INTER_AREA
    return cv2.resize(img, (desired_width, desired_height), interpolation=interp)


def load_clamped(path: str, max_size: int) -> np.ndarray:
    """Decode ``path`` at working resolution — the fast path for
    load_resized.

    Behavior-identical to ``clamp_to_init_size(file_to_array(path))``
    (the reference's _image.cpp:29-73 rule) but, when the source is much
    larger than ``max_size``, decodes at reduced resolution (libjpeg DCT
    scaling via IMREAD_REDUCED_COLOR_k) and resizes to the EXACT output
    dims computed from the original header dims — so shapes match the
    full-decode path bit-for-bit and only the decode cost shrinks ~k^2.
    The reduce factor keeps the decoded side >= 2x the target so the
    final INTER_AREA still averages >= 2x2 source pixels."""
    probe = probe_size(path)
    if probe is None:
        img = file_to_array(path)
        if img is None:
            raise RuntimeError(f"Error: Image decoding failed: {path}")
        return clamp_to_init_size(img, max_size)
    h, w = probe
    if h < 300 or w < 300 or max_size < 300:
        raise ImageTooSmallError(
            "Error: Image size too small (img.width < 300 or img.height < 300)")
    if max(h, w) <= max_size:
        img = file_to_array(path)
        if img is None:
            raise RuntimeError(f"Error: Image decoding failed: {path}")
        return img
    # exact output dims per the reference rule (clamp_to_init_size)
    if w >= h:
        out_w = max_size
        out_h = int(round(h * (max_size / w)))
    else:
        out_w = int((max_size * w) / h)
        out_h = int(round(h * (out_w / w)))
    k = 8
    while k > 1 and max(h, w) // k < 2 * max_size:
        k //= 2
    try:
        buf = np.fromfile(path, dtype=np.uint8)
    except OSError:
        buf = np.empty(0, np.uint8)
    if buf.size == 0:
        raise RuntimeError(f"Error: Image decoding failed: {path}")
    import cv2
    reduced = {2: cv2.IMREAD_REDUCED_COLOR_2, 4: cv2.IMREAD_REDUCED_COLOR_4,
               8: cv2.IMREAD_REDUCED_COLOR_8}
    img = cv2.imdecode(buf, reduced.get(k, cv2.IMREAD_COLOR))
    if img is None:
        raise RuntimeError(f"Error: Image decoding failed: {path}")
    return cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_AREA)


def clamp_to_init_size(img: np.ndarray, max_size: int) -> np.ndarray:
    """Apply the reference's working-resolution rule (_image.cpp:45-67):
    reject tiny images, clamp the max side to ``max_size``."""
    h, w = img.shape[:2]
    if h < 300 or w < 300 or max_size < 300:
        raise ImageTooSmallError(
            "Error: Image size too small (img.width < 300 or img.height < 300)")
    if max(h, w) > max_size:
        if w >= h:
            return resize_keep_aspect(img, max_size)
        # portrait: scale so the *height* becomes max_size
        # (reference computes the new width = max_size * w / h and resizes
        # keeping aspect, _image.cpp:60-64)
        new_w = int((max_size * w) / h)
        return resize_keep_aspect(img, new_w)
    return img


def _target_dims(h: int, w: int, max_size: int) -> tuple:
    """Post-clamp (h, w) for original dims under the reference's
    working-resolution rule (_image.cpp:45-67), without decoding."""
    if max(h, w) <= max_size:
        return (h, w)
    if w >= h:
        return (int(round(h * (max_size / w))), max_size)
    out_w = int((max_size * w) / h)
    return (int(round(h * (out_w / w))), out_w)


class PendingLoad:
    """In-flight working-resolution decode: per-image futures plus the
    exact post-clamp dims (from header probes) so downstream consumers —
    the batched SIFT chunks — can start on the first decoded images
    while the rest are still decoding (takes `load` off the critical
    path; the reference's lazy load never pays decode serially either,
    _image.cpp:29-73)."""

    def __init__(self, imageset: "ImageSet", todo: List[str],
                 max_size: int, threads: int):
        self._imageset = imageset
        self.todo = todo
        self.max_size = max_size
        # probe BEFORE submitting the decode work: the sequential probe
        # loop otherwise contends with the pool threads for the GIL and
        # a few KB of header reads can take 100x longer
        # (expected post-clamp dims; None where the probe failed —
        # consumers must then block via finalize())
        self.dims: List[Optional[tuple]] = []
        for p in todo:
            pr = probe_size(p)
            self.dims.append(None if pr is None
                             else _target_dims(pr[0], pr[1], max_size))
        self._ex = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, threads))
        self.futures = [self._ex.submit(load_clamped, p, max_size)
                        for p in todo]

    def __len__(self) -> int:
        return len(self.todo)

    def get(self, i: int) -> np.ndarray:
        return self.futures[i].result()

    def finalize(self) -> List[np.ndarray]:
        """Block for every decode, append results to the ImageSet (in
        order), shut the pool down; idempotent."""
        if self._ex is not None:
            for p, f in zip(self.todo, self.futures):
                img = f.result()
                self._imageset.loaded.append(p)
                self._imageset.img_data.append(img)
            self._ex.shutdown(wait=False)
            self._ex = None
        return self._imageset.img_data


class ImageSet:
    """The image collection: dedup'd paths, lazily decoded working-resolution
    images, and full-res reload of connected images only."""

    def __init__(self, paths: Sequence[str] = ()):  # noqa: D401
        self.f_list: List[str] = []
        self.loaded: List[str] = []
        self.img_data: List[np.ndarray] = []
        self.add_images(paths)

    def add_images(self, paths: Sequence[str]) -> None:
        """Dedup against the current list (images::add_images, _image.cpp:14-26)."""
        for p in paths:
            p = str(p)
            if p not in self.f_list:
                self.f_list.append(p)

    def __len__(self) -> int:
        return len(self.f_list)

    def load_resized(self, max_size: int, threads: int = 8) -> None:
        """Decode (threaded) any not-yet-loaded paths at working resolution."""
        pending = self.load_resized_stream(max_size, threads)
        if pending is not None:
            pending.finalize()

    def load_resized_stream(self, max_size: int,
                            threads: int = 8) -> Optional[PendingLoad]:
        """Start decoding any not-yet-loaded paths; returns a PendingLoad
        whose futures complete in submission order (None when nothing to
        do). The caller must finalize() it before reading img_data."""
        todo = [p for p in self.f_list if p not in set(self.loaded)]
        if not todo:
            return None
        return PendingLoad(self, todo, max_size, threads)

    def load_connected_images(self, connected: Sequence[bool],
                              threads: int = 8) -> List[Optional[np.ndarray]]:
        """Full-res decode of only the connected images
        (images::load_connected_images, _image.cpp:76-91)."""
        def _load(args):
            p, use = args
            return file_to_array(p) if use else None

        with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, threads)) as ex:
            return list(ex.map(_load, zip(self.loaded, connected)))

    def clear_images(self) -> None:
        self.img_data = []
        self.loaded = []


def save_image(path: str, img: np.ndarray) -> bool:
    """imwrite equivalent (format by extension, like the viewer's Save);
    without cv2, PNG is written by encode_png."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    cv2 = _cv2()
    if cv2 is not None:
        return bool(cv2.imwrite(str(path), img))
    if not str(path).lower().endswith(".png"):
        raise ImportError(f"writing {path} needs OpenCV (cv2), which is "
                          f"not installed; only PNG writes without it")
    Path(path).write_bytes(encode_png(np.ascontiguousarray(img)))
    return True


def resize_to_thumbnail(img: np.ndarray, size: int = 250) -> np.ndarray:
    """Pad-to-square thumbnail (imgm::resize_image,
    /root/reference/src/math/_img_manipulation.cpp:87-113): scale the long
    side to ``size``, pad the short side symmetrically with black."""
    import cv2
    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    small = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)
    top = (size - nh) // 2
    left = (size - nw) // 2
    out = np.zeros((size, size) + img.shape[2:], img.dtype)
    out[top:top + nh, left:left + nw] = small
    return out


def cylinder_prewarp(img: np.ndarray, focal: float,
                     center: Optional[tuple] = None) -> np.ndarray:
    """Legacy cylindrical pre-warp (images::images_to_cylinder ->
    imgm::project, /root/reference/src/classes/_image.cpp:168-191):
    inverse-map each output pixel through x = f*tan((u-cx)/f),
    y = (v-cy)*sqrt(x^2+f^2)/f around the image center."""
    import cv2
    h, w = img.shape[:2]
    cx = w / 2 if center is None else center[0]
    cy = h / 2 if center is None else center[1]
    u, v = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))
    theta = (u - cx) / focal
    x = focal * np.tan(theta)
    y = (v - cy) * np.sqrt(x * x + focal * focal) / focal
    map_x = (x + cx).astype(np.float32)
    map_y = (y + cy).astype(np.float32)
    return cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_CONSTANT)
