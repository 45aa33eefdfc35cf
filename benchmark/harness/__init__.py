"""The harness's shared machinery: cells, weights, inputs, spans, traces,
the run and its result line."""
