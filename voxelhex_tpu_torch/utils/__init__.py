"""Small host utilities: the PNG encoder (:mod:`.png`)."""
