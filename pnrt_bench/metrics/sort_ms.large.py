"""sort_ms.large: sort_ms.frame's reading in a cell that reports
``frame_ms.large`` (the 2048x2048 frame).  Moves ``frame_ms.large``."""

from pnrt_bench.bench import metric_reader

read = metric_reader("sort_ms.frame")
