"""Small host utilities: the PNG encoder (:mod:`.png`), frame meters and
device traces (:mod:`.profiling`)."""
