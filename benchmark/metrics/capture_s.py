"""s of the host clock in the warm-up and capture of the cell's own step as a
CUDA graph (``graphs.capture_counts()`` of the owner ``detect`` or ``train``,
the traffic's kind): part of ``setup_s``, with the kernel library's build in
a checkout's first run. None in a program without the counters."""


def read(ctx):
    from multibox_tpu_torch import graphs

    counts = getattr(graphs, "capture_counts", None)
    own = counts().get(ctx.traffic["kind"]) if counts else None
    return None if own is None else own["warmup_s"] + own["capture_s"]
