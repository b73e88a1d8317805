"""live_share.large: live_share.frame's reading in a cell that reports
``frame_ms.large`` (the 2048x2048 frame).  Moves ``frame_ms.large``."""

from pnrt_bench.bench import metric_reader

read = metric_reader("live_share.frame")
