"""ms a traced step in the program's staging of its inputs
(``graphs.StagedInputs.put``: the batch and the step's host values into the
pinned buffer, the copy's enqueue), less its wait for the previous copy."""
from benchmark import spans


def read(ctx):
    return spans.per_traced_ms(ctx, "graphs.stage", ("graphs.stage.wait",))
