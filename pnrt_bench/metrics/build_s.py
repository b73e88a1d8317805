"""build_s: host seconds of ``SceneBuilder.build`` (BVH, light list,
environment tables, traversal layout, bricks) up to the scene on the
card.  Moves ``setup_s``."""


def read(run):
    return run.setup.get("build_s")
