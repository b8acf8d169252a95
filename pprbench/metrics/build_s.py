"""build_s: host seconds of the set-up's index build
(``index.build_walk_index``: the walks, K7's pack, the copy back), ended
by a synchronise of the device.  None without an index."""


def read(run):
    return run.setup.get("build_s")
