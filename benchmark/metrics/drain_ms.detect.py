"""ms a traced batch in the detect loop's drain (``inference.run_detect_loop``:
unpacking and filtering each image's detections on the host), less its wait
for the group's results."""
from benchmark import spans


def read(ctx):
    return spans.per_traced_ms(ctx, "detect.drain", ("detect.drain.wait",))
