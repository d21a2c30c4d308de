"""Pipeline stages after the fit (port of ``smpltpu/pipeline``)."""
