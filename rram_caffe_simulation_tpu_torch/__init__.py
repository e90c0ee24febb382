"""The PyTorch/CUDA port of rram_caffe_simulation_tpu.

It mirrors the reference package's subpackages (proto, data, core, net,
ops, fault, solver) and replaces its Pallas TPU kernels with CUDA C++
kernels for Hopper (csrc/), built with nvcc at first use. It imports
neither JAX nor the reference package. Entry points run on the card
unless the caller passes device="cpu".
"""
