"""Seeded synthetic orbital scene: terrain, two along-track views, truth.

Builds, from one integer seed, everything a 2-view reconstruction needs and
what it should produce:

  * a procedural multi-octave heightfield on a sphere of radius
    ``EARTH_RADIUS_KM``, its relief inside the camera model's Earth band
    (config.EARTH_MIN/MAX_KM_FROM_CENT), with a band-limited ground texture
    (albedo times Lambertian sun shading, so both views see the same
    radiance at the same ground point);
  * two pinhole cameras ``BASELINE_KM`` apart along the track at
    ``ALTITUDE_KM``, both aimed at the scene centre, with the focal length
    and field of view of the reference's everest Pipeline2View pair (about
    16 m ground sample distance at 1024 px);
  * the images, rendered by casting each pixel's ray through the package's
    own camera model (core/camera_math.pixel_to_ray) onto the heightfield;
  * a seed image of unrelated terrain (another seed) from camera 0.

``write_scene`` lays this out as a directory that io.images.load_directory
reads as it is (binary PGM views plus params.csv) and a seed PGM beside it.
``Scene.height_error_km`` measures a reconstructed cloud against the true
surface.  Everything is float64 numpy on the host except the camera model,
which runs on the CPU device, so a seed gives the same scene everywhere.

Run ``python -m ssrlcv_tpu.io.scene -o DIR --seed S [--size N]`` to write one.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

# [EARTH_RADIUS_KM, EARTH_RADIUS_KM + RELIEF_KM] lies inside the camera
# model's Earth band (config.EARTH_MIN/MAX_KM_FROM_CENT)
EARTH_RADIUS_KM = 6371.0      # heightfield datum
RELIEF_KM = 4.0               # heights span [0, RELIEF_KM] above the datum
ALTITUDE_KM = 400.0           # MOCI's orbit (SSRLCV README)
BASELINE_KM = 70.0            # the everest pair's camera separation
FOCAL = 0.8593                # everest pair focal length (image-plane units)
FOV_PER_PX = 0.0418879 / 1024  # everest pair field of view per pixel, rad
SCENE_LAT_LON_DEG = (27.99, 86.93)
SUN_AZ_EL_DEG = (135.0, 40.0)

# the smallest ground wavelength in the texture, in ground samples.  Above
# 2 the pixel-centre renderer does not alias (aliasing would show the two
# views different fine texture at one ground point); 5 gives about 30k SIFT
# features per 1024^2 view, near the everest pair's 32k and 36k
_MIN_WAVELENGTH_PX = 5.0


@dataclasses.dataclass
class Scene:
    """A rendered scene.  Positions are km, ECEF unless noted; ``ecef_offset``
    is camera 0's position, which load_directory subtracts from every
    camera (the reconstruction frame)."""

    images: list            # [(S, S) uint8] views 0 and 1
    seed_image: np.ndarray  # (S, S) uint8, unrelated terrain from camera 0
    cam_pos: np.ndarray     # (2, 3) float32, ECEF
    cam_rot: np.ndarray     # (2, 3) float32 XYZ Euler angles
    fov: float              # rad, both axes
    foc: float
    dpix: float
    ecef_offset: np.ndarray  # (3,) float32 = cam_pos[0]
    truth: np.ndarray       # (S, S, 3) float64 ground point seen by each
                            # pixel of view 0, reconstruction frame
    terrain: "_Terrain"

    @property
    def size(self) -> int:
        return int(self.images[0].shape[0])

    def height_error_km(self, points: np.ndarray) -> np.ndarray:
        """Signed height of reconstructed points (reconstruction frame, km)
        above the true surface at their ground position."""
        p = np.asarray(points, np.float64) + self.ecef_offset.astype(np.float64)
        return self.terrain.height_above(p)


@dataclasses.dataclass
class _Terrain:
    """Height and ground radiance on a regular grid over the local tangent
    plane (east, north) at the scene centre; a point's ground position is
    its direction from the Earth's centre scaled to the datum."""

    east: np.ndarray
    north: np.ndarray
    half_width: float       # km, grid covers [-half_width, half_width]^2
    height: np.ndarray      # (G, G) km, row = north, column = east
    radiance: np.ndarray    # (R, R) in [0, 1]

    def ground(self, p: np.ndarray):
        d = p / np.linalg.norm(p, axis=-1, keepdims=True)
        return EARTH_RADIUS_KM * (d @ self.east), EARTH_RADIUS_KM * (d @ self.north)

    def _sample(self, grid: np.ndarray, a, b):
        n = grid.shape[0]
        step = 2.0 * self.half_width / (n - 1)
        x = np.clip((a + self.half_width) / step, 0.0, n - 1.000001)
        y = np.clip((b + self.half_width) / step, 0.0, n - 1.000001)
        x0, y0 = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
        fx, fy = x - x0, y - y0
        g00, g01 = grid[y0, x0], grid[y0, x0 + 1]
        g10, g11 = grid[y0 + 1, x0], grid[y0 + 1, x0 + 1]
        return ((g00 * (1 - fx) + g01 * fx) * (1 - fy)
                + (g10 * (1 - fx) + g11 * fx) * fy)

    def height_at(self, a, b):
        return self._sample(self.height, a, b)

    def radiance_at(self, a, b):
        return self._sample(self.radiance, a, b)

    def height_above(self, p: np.ndarray) -> np.ndarray:
        a, b = self.ground(p)
        return np.linalg.norm(p, axis=-1) - EARTH_RADIUS_KM - self.height_at(a, b)


def _spectral_field(rng, n: int, spacing: float, slope: float,
                    min_wavelength: float, max_wavelength: float) -> np.ndarray:
    """Zero-mean, unit-std random field on an (n, n) grid: white noise with
    amplitude spectrum k^-slope, band-passed to
    [min_wavelength, max_wavelength] (km)."""
    k = np.fft.fftfreq(n, d=spacing)
    kk = np.hypot(k[:, None], k[None, :])
    band = (kk <= 1.0 / min_wavelength) & (kk >= 1.0 / max_wavelength)
    amp = np.where(band, np.maximum(kk, 1e-12) ** -slope, 0.0)
    noise = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    f = np.real(np.fft.ifft2(noise * amp))
    return (f - f.mean()) / max(f.std(), 1e-12)


def _make_terrain(seed_seq, east, north, half_width: float,
                  gsd: float) -> _Terrain:
    rng = np.random.default_rng(seed_seq)
    # height: smooth (k^-2 amplitude) relief, wavelengths 0.5 km .. the scene
    hs = 0.04
    ng = int(np.ceil(2 * half_width / hs)) + 1
    h = _spectral_field(rng, ng, hs, 2.0, 0.5, 4 * half_width)
    h = (h - h.min()) / (h.max() - h.min()) * RELIEF_KM
    # Lambertian shading from the height grid's normals
    gy, gx = np.gradient(h, hs)
    az, el = np.radians(SUN_AZ_EL_DEG)
    sun = np.array([np.cos(el) * np.sin(az), np.cos(el) * np.cos(az), np.sin(el)])
    shade = np.clip((-gx * sun[0] - gy * sun[1] + sun[2]) / np.sqrt(1 + gx * gx + gy * gy),
                    0.0, 1.0)
    # albedo: equal energy per octave (k^-1), from 3 ground samples up
    rs = gsd / 2.0
    nr = int(np.ceil(2 * half_width / rs)) + 1
    alb = _spectral_field(rng, nr, rs, 1.0, _MIN_WAVELENGTH_PX * gsd, 4 * half_width)
    alb = 0.5 + 0.4 * np.tanh(0.8 * alb)
    t = _Terrain(east, north, half_width, h, np.zeros((2, 2)))
    xs = np.linspace(-half_width, half_width, nr)
    a, b = np.meshgrid(xs, xs)
    shade_r = t._sample(shade, a, b)
    t.radiance = alb * (0.4 + 0.6 * shade_r)
    return t


def _local_frame():
    lat, lon = np.radians(SCENE_LAT_LON_DEG)
    up = np.array([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)])
    east = np.array([-np.sin(lon), np.cos(lon), 0.0])
    north = np.cross(up, east)
    return up, east, north


def _cameras():
    """Camera positions (float32 ECEF) and Euler angles (float32) of the
    pair, as they are written to params.csv."""
    from ssrlcv_tpu.core import camera_math

    up, east, north = _local_frame()
    centre = EARTH_RADIUS_KM * up
    above = centre + ALTITUDE_KM * up
    pos = np.stack([above - 0.5 * BASELINE_KM * north,
                    above + 0.5 * BASELINE_KM * north])
    track = north
    rots = []
    for c in pos:
        z = centre - c
        z /= np.linalg.norm(z)
        x = track - (track @ z) * z
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z], axis=1)  # camera axes as world columns
        rots.append(np.asarray(camera_math.axis_rotations(_on_cpu(R))))
    return pos.astype(np.float32), np.stack(rots).astype(np.float32)


def _on_cpu(x):
    import jax

    return jax.device_put(np.asarray(x, np.float32), jax.devices("cpu")[0])


def _render(terrain: _Terrain, cam_pos, cam_rot, fov: float, size: int):
    """(size, size) radiance and the hit points (ECEF float64) of every
    pixel's ray, through camera_math.pixel_to_ray."""
    import jax

    from ssrlcv_tpu.core import camera_math

    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    loc = np.stack([xs, ys], axis=-1).reshape(-1, 2)
    with jax.default_device(jax.devices("cpu")[0]):
        vec, _ = camera_math.pixel_to_ray(
            _on_cpu(loc), _on_cpu(np.zeros(3)), _on_cpu(cam_rot),
            np.float32(FOCAL), np.float32(fov),
            jax.device_put(np.array([size, size], np.int32), jax.devices("cpu")[0]))
    v = np.asarray(vec, np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    c = np.asarray(cam_pos, np.float64)
    cv = v @ c
    cc = c @ c

    def t_at(r):
        return -cv - np.sqrt(cv * cv - cc + r * r)

    # fixed point t = t_at(R + h(ground(C + t v))): a contraction for the
    # terrain's slopes at these near-nadir view angles (checked by
    # convergence below), so the hit is unique and nothing is occluded
    t = t_at(EARTH_RADIUS_KM + 0.5 * RELIEF_KM)
    for _ in range(60):
        p = c + t[:, None] * v
        t_new = t_at(EARTH_RADIUS_KM + terrain.height_at(*terrain.ground(p)))
        step = np.max(np.abs(t_new - t))
        t = t_new
        if step < 1e-9:
            break
    else:
        raise RuntimeError(f"ray casting did not converge (last step {step} km)")
    p = c + t[:, None] * v
    rad = terrain.radiance_at(*terrain.ground(p))
    return rad.reshape(size, size), p.reshape(size, size, 3)


def make_scene(seed: int, size: int = 1024) -> Scene:
    """Build and render the scene for ``seed`` at ``size`` x ``size`` px."""
    fov = FOV_PER_PX * size
    gsd = ALTITUDE_KM * FOV_PER_PX
    _, east, north = _local_frame()
    cam_pos, cam_rot = _cameras()
    # ground half-width seen by either view, with margin for relief parallax
    half_width = 0.5 * size * gsd * 1.3 + RELIEF_KM * BASELINE_KM / ALTITUDE_KM
    terrain = _make_terrain(np.random.SeedSequence([seed, 0]), east, north,
                            half_width, gsd)
    seed_terrain = _make_terrain(np.random.SeedSequence([seed, 1]), east, north,
                                 half_width, gsd)

    def to_u8(rad):
        return np.clip(np.round(255.0 * rad), 0, 255).astype(np.uint8)

    images, truth = [], None
    for i in range(2):
        rad, pts = _render(terrain, cam_pos[i], cam_rot[i], fov, size)
        images.append(to_u8(rad))
        if i == 0:
            truth = pts - cam_pos[0].astype(np.float64)
    seed_rad, _ = _render(seed_terrain, cam_pos[0], cam_rot[0], fov, size)
    dpix = FOCAL * np.tan(fov / 2.0) / (size / 2.0)
    return Scene(images=images, seed_image=to_u8(seed_rad), cam_pos=cam_pos,
                 cam_rot=cam_rot, fov=float(np.float32(fov)),
                 foc=float(np.float32(FOCAL)), dpix=float(np.float32(dpix)),
                 ecef_offset=cam_pos[0].copy(), truth=truth, terrain=terrain)


VIEW_NAMES = ("view0.pgm", "view1.pgm")


def write_scene(scene: Scene, root: str) -> tuple[str, str]:
    """Write ``root/views/`` (the two views + params.csv) and
    ``root/seed.pgm``.  Returns (views directory, seed image path)."""
    from ssrlcv_tpu.io.images import write_netpbm

    views = os.path.join(root, "views")
    os.makedirs(views, exist_ok=True)
    rows = []
    for i, name in enumerate(VIEW_NAMES):
        write_netpbm(os.path.join(views, name), scene.images[i])
        vals = ([*scene.cam_pos[i], *scene.cam_rot[i], scene.fov, scene.fov,
                 scene.foc, scene.dpix, scene.dpix])
        # float32 values written exactly, so the loader reads the cameras
        # the images were rendered with
        rows.append(",".join([name] + [repr(float(np.float32(v))) for v in vals]
                             + ["0", str(scene.size), str(scene.size)]))
    with open(os.path.join(views, "params.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    seed_path = os.path.join(root, "seed.pgm")
    write_netpbm(seed_path, scene.seed_image)
    return views, seed_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ssrlcv-scene", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-o", "--output", required=True, help="directory to write")
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("--size", type=int, default=1024, help="image side, px")
    args = p.parse_args(argv)
    views, seed_path = write_scene(make_scene(args.seed, args.size), args.output)
    print(f"wrote {views} and {seed_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
