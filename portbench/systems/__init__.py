"""Systems under test. A configuration file names its system by `"system":
"<module>"`, and the run (run.py) drives only what that module gives: its
class `System(config, traffic, seed, device, control=False)`.

- The constructor is the set-up: it makes the inputs from the seed, builds
  the program with the configuration's flags (or, with `control`, the
  configuration's control in the program's place) and warms up every shape
  the traffic uses, and nothing else.
- `run(seconds, tracer)` is the window: it drives the program for
  `seconds` and returns a records.Window (or a subclass) of the requests it
  finished; it marks its calls into the program with `tracer.span(name)`.
- `release()` frees the program's state, so that the check that follows
  finds the card's memory free.
- `check(window)` holds what the window produced to the configuration's
  plain reference (references/) and returns a records.Verdict.

What a system needs of the program it imports inside these methods, never
at import. A new system, such as serving or training, is a new module here
and a configuration that names it.
"""
