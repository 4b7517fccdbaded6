"""One module per entry that a window drives, named by a configuration's
``entry``. Each has a ``Driver(config, inputs, workdir, device)`` with:

- ``build(i, span)``: one build, the timed path; returns (result, info),
  ``info`` the program's own stage seconds;
- ``outputs(i, result)``: what the build produced, as host arrays;
- ``release(i)``: drop what build ``i`` left on disk, adding its size to
  ``released_bytes``; a build drops its predecessor's unless the harness
  lists it in ``keep`` (the builds the check reads);

and two functions that need nothing of the program:

- ``reference(config, inputs, device, max_rounds=None)``: the plain
  reference's outputs and the input's sizes (``text_n``, ``bases``,
  ``rounds``); with ``max_rounds``, the control;
- ``check(got, want)``: the numbers compared, each a count of differing
  entries, all held to 0.
"""
