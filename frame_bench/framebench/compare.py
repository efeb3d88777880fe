"""The comparison that decides `correct`: a frame of the timed window against
the plain reference's frame of the same scene, pixel by pixel in the encoded
8-bit channels.

Numbers compared, each against a limit in the configuration's file:
* `px_off_share`: the share of pixels whose hit differs (one frame has the
  pixel, the other leaves it 0) or whose largest channel gap exceeds
  OFF_LEVELS steps of 255. Sound frames differ only where a ray grazes an
  edge or a threshold and the rounding of two float32 programs takes it
  either way;
* `mean_abs_levels`: the mean channel gap in steps of 255 over every pixel,
  which a small shift spread over the whole frame moves;
* `frames_failed`: the window's frames that dropped or left rays untraced,
  or whose bits differ from the run's first frame (limit 0).
"""

from __future__ import annotations

import numpy as np

OFF_LEVELS = 2


def _rgb(px: np.ndarray) -> np.ndarray:
    px = px.astype(np.uint32)
    return np.stack([(px >> 16) & 0xFF, (px >> 8) & 0xFF, px & 0xFF], -1).astype(np.int16)


def frame_numbers(got: np.ndarray, ref: np.ndarray) -> dict:
    if got.shape != ref.shape:
        raise ValueError(f"frames of {got.shape} and {ref.shape} pixels")
    gap = np.abs(_rgb(got) - _rgb(ref))
    off = ((got != 0) != (ref != 0)) | (gap.max(1) > OFF_LEVELS)
    return {"px_off_share": float(off.mean()), "mean_abs_levels": float(gap.mean())}


def checks(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every number that has a limit."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits if k in numbers}


def passed(checked: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checked.values())
