"""The repository's examples on the port: `semesterbild.py` (flags of the
JAX package's examples/semesterbild.py plus `--device`), `test_scene.py`
and `test_text.py`. Run each with `python -m` or as a file."""
