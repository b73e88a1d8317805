"""capture_s: host seconds to warm up and capture the cell's programs
(``render/program.py`` frames).  Moves ``setup_s``."""


def read(run):
    return run.setup.get("capture_s")
