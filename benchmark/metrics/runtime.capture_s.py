"""runtime.capture_s: seconds the runtime spent capturing its engines in
set-up, the sum of `compile_seconds` over `Engine.get_engine_infor()` of
every captured engine."""


def read(run):
    captured = [e["compile_seconds"] for e in run.engines.values() if e.get("compiled")]
    return sum(captured) if captured else None
