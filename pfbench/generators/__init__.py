"""One module per input generator, named by a traffic file's
``generator``: ``make(config, traffic, seed, workdir)`` writes the inputs
under ``workdir`` from the seed, at the configuration's scale and with the
traffic's data model, and returns their paths."""
