"""The benchmark's plain references: one step of a configuration's physics,
in plain torch, with no code of the program. Each is a module of its own
here, named by the configuration's ``reference`` key, with
``step(pos, vel, mass, radius, rows, params, precision=...)``."""
