"""Kernels: the paged decode kernel's roofline share, read by
``paged_decode_roofline.py`` as it stands, in the cells whose end-to-end
metrics are latencies.  A metric entry names the one end-to-end metric
it moves, so each kind of cell has an entry, and this file, of its own."""

from pathlib import Path

import harness

read = harness.load_module(
    Path(__file__).with_name("paged_decode_roofline.py"),
    "rtbench_metric_paged_decode_roofline").read
