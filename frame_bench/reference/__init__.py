"""The plain reference renderers of the frame benchmark, one module each, with
the scene preparation they work out for themselves (`geometry.py`,
`lights.py`). A configuration file names its reference as
`"reference": "<module>"` (`whitted` without the key); `framebench.spec.reference`
imports it as `reference.<module>`.

A reference module exposes
`reference_frame(raw, render, width, height, seed, device, dtype=torch.float32)`:
the frame of the raw scene under the configuration's `render` settings, as
(H*W,) uint32 0xFFRRGGBB, row-major, 0 where nothing was hit. It imports
torch and numpy only: neither the port nor the JAX package.

`whitted.py`: the Whitted renderer of standard quality (one ray a pixel,
depth 9/8, 10 lights a light with soft shadows)."""
