"""The plain reference renderer of the frame benchmark (`whitted.py`), with
the scene preparation it works out for itself (`geometry.py`, `lights.py`).
It imports torch and numpy only."""
