"""ms a traced batch in the program's staging of its inputs
(``graphs.StagedInputs.put``: the fill of the pinned buffer and the copy's
enqueue), less its wait for the previous copy out of that buffer."""
from benchmark import spans


def read(ctx):
    return spans.per_traced_ms(ctx, "graphs.stage", ("graphs.stage.wait",))
