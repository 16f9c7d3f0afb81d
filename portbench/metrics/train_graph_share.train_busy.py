"""train_graph_share.train_busy (%): ``train_graph_share.train`` read in a
cell whose end-to-end metric is the card's time per training image
(``train_device_ms_per_image``): the same counters over the same window."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_metric_train_graph_share_train",
    Path(__file__).with_name("train_graph_share.train.py"))
_share = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_share)  # turns the tracer on

read = _share.read
