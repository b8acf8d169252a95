"""layout_s: host seconds of the set-up's graph layout
(``graph.csr.to_device``: the duplicate-edge merge, the hub split, the
copies to the device, the gather's work lists), ended by a synchronise
of the device."""


def read(run):
    return run.setup.get("layout_s")
