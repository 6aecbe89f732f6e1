"""The one traffic generator: a mix file's parameters and a seed -> the
pool of requests a run cycles through.

A mix (``portbench/mixes/<name>.json``) names a scene generator of
``scenes.GENERATORS`` and its parameters, the number of distinct cameras
(scenes), the pool size and the sensor noise. Camera ``c`` sees the scene
made from ``SeedSequence([seed, c])``; request ``p`` of the pool draws its
noise from ``SeedSequence([seed, 1_000_000 + p])``, so every frame of the
pool is distinct and the same seed gives the same pool.
"""

from __future__ import annotations

import numpy as np

from portbench.traffic import scenes

NOISE_STREAM = 1_000_000


def camera_scenes(mix: dict, frame: dict, seed: int) -> list:
    """One [H, W] u16 range frame per camera of the mix."""
    gen = scenes.GENERATORS[mix["generator"]]
    out = []
    for c in range(mix["cameras"]):
        pts = gen(frame["rows"], frame["cols"], f=frame["f"],
                  seed=np.random.SeedSequence([seed, c]), **mix["scene"])
        out.append(scenes.encode_range(pts, frame["depth_scale"]))
    return out


def pool(mix: dict, frame: dict, batch: int, seed: int) -> list:
    """``mix["pool"]`` requests, each [batch, H, W] u16: frame ``b`` of a
    request is camera ``b % cameras`` plus fresh noise of up to
    ``mix["noise_units"]`` units."""
    cams = camera_scenes(mix, frame, seed)
    out = []
    for p in range(mix["pool"]):
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, NOISE_STREAM + p]))
        out.append(np.stack([
            scenes.jitter(cams[b % len(cams)], 1, mix["noise_units"],
                          rng)[0] for b in range(batch)]))
    return out


def rays_and_origin(frame: dict):
    """The camera's [H, W, 3] f32 ray table and its [3] f32 origin."""
    return (scenes.camera_ray_table(frame["rows"], frame["cols"],
                                    frame["f"]),
            np.zeros(3, np.float32))
