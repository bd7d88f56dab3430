"""The benchmark's plain reference: textbook HMM recursions and the model
constructions of the two configurations, in plain PyTorch and NumPy.

Nothing here imports the port: the constructions are written out again
from the configurations' definitions (frozen copies of the plain
versions), and the trained Dirichlet mixtures are copies of the raw
``.npz`` files. Every function takes a :class:`~.hmm.Precision`: float64
for the truth, float32 with TF32-rounded products for the lower-precision
control.
"""
