"""The plain reference that decides ``correct``.

Plain NumPy on the host and plain PyTorch on whatever device it is given.
It imports neither jax, pfbwtf_tpu nor pfbwtf_tpu_torch, and takes nothing
that the program made: it reads the benchmark's own input files (the FASTA,
the VCF) and works out the text, its suffix array, the BWT, the run-length
samples and the marker arrays again from them.
"""
