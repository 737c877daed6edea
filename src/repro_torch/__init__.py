"""WeiPS in PyTorch for an NVIDIA H100: the port of the JAX/Pallas package
``repro`` (which stays in the repository as the reference).

Module for module the layout and public names follow ``repro``; every
Pallas kernel on a ported path is a CUDA C++ kernel for ``sm_90a`` under
``kernels/csrc/``, built with ``nvcc`` at first use. Importing the package
needs neither ``nvcc`` nor a GPU: off the card, each kernel wrapper runs
its plain PyTorch version on CPU tensors.

Ported so far: the online-learning loop's main path — train (FTRL on
master shards, ``training.TrainingPlane``), sync (the int8 delta stream,
``core.streaming``) and serve (``serving.ServingPlane`` over the slave
replica sets the stream feeds).
"""
