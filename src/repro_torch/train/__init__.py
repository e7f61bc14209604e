"""Training state, loop and callbacks (port of ``repro.train``)."""
