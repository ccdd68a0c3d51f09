"""The load loops a traffic mix names as its `loop`: `loops/<name>.py`
holds `PARAMS` (the whole-number parameters the mix must give),
`warm(solve, stream, mix)`, `window(solve, stream, seconds, mix, sync)`
and `trace_inputs(stream, mix)`."""
