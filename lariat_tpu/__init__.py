"""lariat_tpu: a linked-read aligner with its DP hot loops on an accelerator.

A from-scratch rebuild of the capabilities of 10XGenomics/lariat (BWA-MEM
candidate generation + RFA read-cloud inference): JAX/XLA device kernels
for seeding and the seed-extend, mate-rescue and global DP waves, a host
pipeline for chaining, RFA, I/O and BAM emission, and barcode
data-parallelism across worker processes.
"""

__version__ = "0.1.0"
