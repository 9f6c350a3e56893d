"""The plain reference the benchmark judges the program by.

Plain PyTorch in float32 (TF32 off), written from the models' equations and
the configuration's stated semantics, with no kernel, cache layout or
batching trick of the program.  It imports nothing of ``repro_torch`` and
takes nothing the program made: it draws the weights and the traffic again
from the seed and works out the packing, the link's capacities and the
optimizer's update itself.  ``precision.Precision`` lowers its matrix
products' operands for the control.
"""
