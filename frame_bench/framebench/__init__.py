"""The frame benchmark's harness: the cell's data (`spec`), the system under
test behind one adapter (`port`), the timed window (`window`), the traced
frames and their arithmetic (`tracing`), the roofline yardstick
(`roofline`) and the comparison that decides `correct` (`compare`).
`cell.run` drives one run; `frame_bench/run.py` is its command line."""
