"""Plain references of what the benchmark's cells compute.

Plain numpy, scipy and PyTorch, written from the inputs the benchmark
makes: they import nothing of ``vican_torch``, the JAX package or JAX, and
take nothing the port derived.  :mod:`.perception` detects the markers of
frames and solves their poses; :mod:`.solve` synchronizes a camera network.
Each takes a precision, so the same code in a lower one is the control that
a check has to fail.
"""
