"""PyTorch port: the `python -m hslu_i.ba_raytracing.f2501_raytracer_tpu_torch`
CLI (the JAX package's flags, presets and PNG output, plus `--device`):
its PNG is the renderer's frame, every scene renders under every preset on
the CPU when asked, without a card it stops with the device message, and a
run imports nothing of JAX."""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import RaytracerRenderer, RenderConfig
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.__main__ import main
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import build
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.output import read_png

from test_torch_renderer import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "hslu_i.ba_raytracing.f2501_raytracer_tpu_torch"
# the CLI's processes take one intra-op thread too (see one_torch_thread)
ENV = dict(os.environ, OMP_NUM_THREADS="1")


def _run(*args, env=ENV):
    return subprocess.run([sys.executable, "-m", MODULE, *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env=env)


def test_cli_png_is_the_renderers_frame(tmp_path):
    out = tmp_path / "cli.png"
    run = _run("--scene", "semesterbild", "--preset", "default", "--width", "16",
               "--height", "8", "--device", "cpu", "--out", str(out))
    assert run.returncode == 0, run.stderr
    assert f"saved {out}" in run.stdout
    cfg = dataclasses.replace(RenderConfig.default_scene(width=16, height=8),
                              scene_backface_culling=True)
    want = RaytracerRenderer(cfg, device="cpu").render(build("semesterbild", cfg)).as_u8()
    np.testing.assert_array_equal(read_png(out), want)
    assert want.max() > 0


@pytest.mark.parametrize("preset", ["default", "realistic", "reference_default"])
@pytest.mark.parametrize("scene", ["semesterbild", "test_scene", "test_text"])
def test_cli_renders_every_scene_and_preset(scene, preset, tmp_path, capsys):
    out = tmp_path / f"{scene}_{preset}.png"
    main(["--scene", scene, "--preset", preset, "--width", "4", "--height", "2",
          "--device", "cpu", "--out", str(out)])
    assert "Render timing done!" in capsys.readouterr().out
    assert read_png(out).shape == (2, 4, 3)


def test_cli_progress_flag_renders_tile_by_tile(tmp_path, capsys):
    out = tmp_path / "p.png"
    main(["--scene", "test_text", "--preset", "default", "--width", "8", "--height", "4",
          "--device", "cpu", "--progress", "--out", str(out)])
    assert "100.0%" in capsys.readouterr().out
    assert read_png(out).shape == (4, 8, 3)


def test_cli_without_a_card_needs_device_cpu(tmp_path):
    env = dict(ENV, CUDA_VISIBLE_DEVICES="")  # no card, whatever the machine
    run = _run("--width", "4", "--height", "2", "--out", str(tmp_path / "x.png"), env=env)
    assert run.returncode != 0
    assert "no CUDA device is available" in run.stderr and "--device cpu" in run.stderr
    assert not (tmp_path / "x.png").exists()


def test_cli_run_imports_no_jax(tmp_path):
    code = (
        "import sys\n"
        f"from {MODULE}.__main__ import main\n"
        f"from {MODULE}.output import http_preview, preview\n"
        f"from {MODULE}.models import test_scene, test_text\n"
        f"main(['--scene', 'test_text', '--preset', 'default', '--width', '4', '--height', '2',"
        f" '--device', 'cpu', '--out', {str(tmp_path / 'x.png')!r}])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "       or m == 'hslu_i.ba_raytracing.f2501_raytracer_tpu'\n"
        "       or m.startswith('hslu_i.ba_raytracing.f2501_raytracer_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=ENV)
    assert run.returncode == 0 and run.stdout.strip().endswith("ok"), run.stderr
