"""Roofline tooling for the H100: the hardware profile the cost passes
divide by (``constants``), the collective and cost reading of a recorded
program (``hlo``), the roofline terms of a cell (``analysis``) and their
tables (``report``)."""
