"""Image + camera-parameter loading.

Replicates the reference's image ingestion (Image.cu:95-170): read a
PGM/PPM/PNG/JPEG/TIFF, find the sibling ``params.csv`` and take the row whose first
field matches the image filename, filling the Camera.  The ECEF offset of
image 0 is subtracted from every camera position (Pipeline.cu:37-40) so the
reconstruction is centred near the origin.

Binary PGM/PPM are read and written with numpy alone; PNG, JPEG and TIFF
need PIL, imported only for those files.  Pixels go to device once as a
single uint8 array (no dual-residency state machine).
"""

from __future__ import annotations

import csv
import os
from typing import Iterable, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from ssrlcv_tpu.core.types import Cameras
from ssrlcv_tpu.io.refdata import RefImage

NETPBM_EXTENSIONS = (".pgm", ".ppm")
IMAGE_EXTENSIONS = NETPBM_EXTENSIONS + (".png", ".jpg", ".jpeg", ".tif", ".tiff")


def _pil():
    try:
        from PIL import Image as PILImage
    except ImportError as e:
        raise ImportError(
            "reading or writing PNG/JPEG/TIFF needs the Pillow package (PIL), "
            "which is not installed; PGM and PPM need nothing beyond numpy"
        ) from e
    return PILImage


def read_netpbm(path: str) -> np.ndarray:
    """Read a binary 8-bit PGM (P5) as (H, W) or PPM (P6) as (H, W, 3)."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:  # magic, width, height, maxval
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":  # comment to end of line
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        if end == pos:
            raise ValueError(f"{path}: truncated netpbm header")
        fields.append(data[pos:end])
        pos = end
    magic, w, h, maxval = fields[0], int(fields[1]), int(fields[2]), int(fields[3])
    channels = {b"P5": 1, b"P6": 3}.get(magic)
    if channels is None:
        raise ValueError(f"{path}: not a binary PGM/PPM (magic {magic!r})")
    if maxval != 255:
        raise ValueError(f"{path}: only 8-bit netpbm is supported (maxval {maxval})")
    pos += 1  # the single whitespace byte that ends the header
    n = w * h * channels
    if len(data) - pos < n:
        raise ValueError(f"{path}: {len(data) - pos} pixel bytes, expected {n}")
    px = np.frombuffer(data, np.uint8, count=n, offset=pos)
    return px.reshape((h, w) if channels == 1 else (h, w, 3)).copy()


def write_netpbm(path: str, pixels: np.ndarray) -> None:
    """Write (H, W) uint8 as binary PGM or (H, W, 3) uint8 as binary PPM."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    if pixels.ndim == 2:
        magic = b"P5"
    elif pixels.ndim == 3 and pixels.shape[2] == 3:
        magic = b"P6"
    else:
        raise ValueError(f"netpbm needs (H, W) or (H, W, 3) pixels, got {pixels.shape}")
    h, w = pixels.shape[:2]
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n255\n" % (w, h))
        f.write(pixels.tobytes())


def read_image(path: str) -> np.ndarray:
    """Read an image file as (H, W) or (H, W, C) uint8."""
    if path.lower().endswith(NETPBM_EXTENSIONS):
        return read_netpbm(path)
    with _pil().open(path) as im:
        return np.asarray(im)


def write_image(path: str, pixels: np.ndarray) -> None:
    if path.lower().endswith(NETPBM_EXTENSIONS):
        write_netpbm(path, pixels)
    else:
        _pil().fromarray(pixels).save(path)


def to_grayscale(pixels: np.ndarray) -> np.ndarray:
    """Average-channel BW conversion (reference convertToBW / generateBW
    kernel averages channels, Image.cuh:593)."""
    if pixels.ndim == 2:
        return pixels
    return (pixels.astype(np.float32).mean(axis=-1) + 0.5).astype(np.uint8)


def _camera_row_to_dict(row: Sequence[str]) -> dict:
    """Parse one params.csv camera row (14 fields — README.md:120-140):
    filename,x,y,z,rx,ry,rz,fov_x,fov_y,foc,dpix_x,dpix_y,timestamp,size_x[,size_y]
    """
    vals = [v.strip() for v in row]
    d = {
        "filename": vals[0],
        "cam_pos": np.array([float(vals[1]), float(vals[2]), float(vals[3])], np.float32),
        "cam_rot": np.array([float(vals[4]), float(vals[5]), float(vals[6])], np.float32),
        "fov": np.array([float(vals[7]), float(vals[8])], np.float32),
        "foc": float(vals[9]),
        "dpix": np.array([float(vals[10]), float(vals[11])], np.float32),
        "timestamp": int(float(vals[12])) if len(vals) > 12 else 0,
    }
    return d


def _pushbroom_row_to_dict(vals: list[str], size: tuple[int, int] | None = None) -> dict:
    """Parse a pushbroom params.csv row:
    ``filename,pushbroom,lat,lon,axis_radius,roll,altitude,foc,gsd_m,fov_deg``
    (Image.cu:108-141).  gsd converts m -> km; fov deg -> rad;
    dpix.x = foc*tan(fov/2)/(size.x/2).  The reference's ``dpix.y = dpix.y``
    self-assignment (Image.cu:139) leaves dpix.y at its zero default —
    replicated."""
    d = {
        "filename": vals[0],
        "pushbroom": {
            "projection_center": np.array([float(vals[2]), float(vals[3])], np.float32),
            "axis_radius": float(vals[4]),
            "roll": float(vals[5]),
            "altitude": float(vals[6]),
            "foc": float(vals[7]),
            "gsd": float(vals[8]) / 1000.0,
            "fov": float(vals[9]) * (np.pi / 180.0),
        },
    }
    pb = d["pushbroom"]
    if size is not None:
        pb["dpix"] = np.array(
            [pb["foc"] * np.tan(pb["fov"] / 2.0) / (size[0] / 2.0), 0.0], np.float32
        )
    else:
        pb["dpix"] = np.zeros(2, np.float32)
    return d


def load_params_csv(path: str, size: tuple[int, int] | None = None) -> dict[str, dict]:
    """Read params.csv into {filename: camera dict}.  Pushbroom rows
    (second field == 'pushbroom', Image.cu:108) parse into a nested
    'pushbroom' dict instead of pinhole fields."""
    out = {}
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            try:
                if len(row) > 1 and row[1].strip().lower() == "pushbroom":
                    d = _pushbroom_row_to_dict([v.strip() for v in row], size)
                else:
                    d = _camera_row_to_dict(row)
            except (ValueError, IndexError) as e:
                # a malformed row silently skipped means the image runs with
                # a ZERO camera and the whole reconstruction quietly
                # collapses — surface it loudly instead
                from ssrlcv_tpu.logging import logger

                logger.err(
                    f"params.csv: cannot parse row {row[:2]}...: {e} — the "
                    "image will have NO camera parameters")
                continue
            out[d["filename"]] = d
    return out


def load_image_with_params(path: str, image_id: int, no_params: bool = False) -> RefImage:
    """Load one image + its params.csv camera row as a RefImage."""
    pixels = to_grayscale(read_image(path))
    h, w = pixels.shape
    img = RefImage(
        id=image_id,
        size=(w, h),
        color_depth=1,
        cam_pos=np.zeros(3, np.float32),
        cam_rot=np.zeros(3, np.float32),
        fov=np.zeros(2, np.float32),
        foc=0.0,
        dpix=np.zeros(2, np.float32),
        timestamp=0,
        ecef_offset=np.zeros(3, np.float32),
        is_pushbroom=False,
        pixels=pixels,
    )
    if not no_params:
        params_path = os.path.join(os.path.dirname(path), "params.csv")
        if os.path.exists(params_path):
            params = load_params_csv(params_path, size=(w, h))
            key = os.path.basename(path)
            if key in params:
                p = params[key]
                if "pushbroom" in p:
                    img.is_pushbroom = True
                    img.pushbroom = p["pushbroom"]
                else:
                    img.cam_pos = p["cam_pos"]
                    img.cam_rot = p["cam_rot"]
                    img.fov = p["fov"]
                    img.foc = p["foc"]
                    img.dpix = p["dpix"]
                    img.timestamp = p["timestamp"]
            else:
                from ssrlcv_tpu.logging import logger

                logger.warn(
                    f"{key}: no row in {params_path} — camera parameters "
                    "stay zero (matching/triangulation will degenerate)")
    return img


def load_directory(dirpath: str, no_params: bool = False) -> list[RefImage]:
    """Load every image in a directory (sorted), offsetting camera positions
    by image 0's position as ECEF offset (Pipeline.cu:37-40)."""
    paths = sorted(
        os.path.join(dirpath, f)
        for f in os.listdir(dirpath)
        if f.lower().endswith(IMAGE_EXTENSIONS)
    )
    images = [load_image_with_params(p, i, no_params) for i, p in enumerate(paths)]
    if images and not no_params:
        offset = images[0].cam_pos.copy()
        for im in images:
            im.ecef_offset = offset
            im.cam_pos = im.cam_pos - offset
    return images


def cameras_from_refimages(images: Iterable[RefImage]) -> Cameras:
    """Stack host RefImages into the batched Cameras pytree."""
    ims = list(images)
    return Cameras(
        cam_pos=jnp.array(np.stack([im.cam_pos for im in ims])),
        cam_rot=jnp.array(np.stack([im.cam_rot for im in ims])),
        fov=jnp.array(np.stack([im.fov for im in ims])),
        foc=jnp.array(np.array([im.foc for im in ims], np.float32)),
        dpix=jnp.array(np.stack([im.dpix for im in ims])),
        size=jnp.array(np.array([[im.size[0], im.size[1]] for im in ims], np.int32)),
        ecef_offset=jnp.array(np.stack([im.ecef_offset for im in ims])),
        timestamp=jnp.array(np.array([im.timestamp for im in ims], np.int64)),
    )


def pushbrooms_from_refimages(images: Iterable[RefImage]):
    """Stack pushbroom RefImages into the batched PushbroomCameras pytree
    (the generateBundles pushbroom dispatch path, PointCloudFactory.cu:878-903).
    Returns None unless image 0 is pushbroom (the reference dispatches on
    images[0]->isPushbroom, PointCloudFactory.cu:845)."""
    from ssrlcv_tpu.core.types import PushbroomCameras

    ims = list(images)
    if not ims or not ims[0].is_pushbroom:
        return None
    n = len(ims)

    def get(key, shape=()):
        return np.array(
            [np.asarray(im.pushbroom[key], np.float32) for im in ims], np.float32
        ).reshape((n,) + shape)

    return PushbroomCameras(
        start_pos=jnp.zeros((n, 3), jnp.float32),
        end_pos=jnp.zeros((n, 3), jnp.float32),
        projection_center=jnp.asarray(get("projection_center", (2,))),
        axis_radius=jnp.asarray(get("axis_radius")),
        roll=jnp.asarray(get("roll")),
        altitude=jnp.asarray(get("altitude")),
        foc=jnp.asarray(get("foc")),
        fov=jnp.asarray(get("fov")),
        gsd=jnp.asarray(get("gsd")),
        dpix=jnp.asarray(get("dpix", (2,))),
        size=jnp.array(np.array([[im.size[0], im.size[1]] for im in ims], np.int32)),
    )


def pixels_stack(images: Iterable[RefImage]) -> jnp.ndarray:
    """Stack same-sized grayscale images to a (N, H, W) uint8 device array."""
    return jnp.array(np.stack([im.pixels for im in images]))
