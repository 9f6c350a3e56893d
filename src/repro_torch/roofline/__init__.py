"""Roofline of one step on one H100: a FLOP/byte counter over torch ops
(``op_cost``), each hand-written kernel's work from its shapes
(``kernel_cost``), the card's peaks (``hw``), the roofline terms
(``analysis``) and the dry-run tables (``report``)."""
