"""Plain PyTorch references of the benchmark's model families, one module
a family (``reference/<family>.py``), imported by the ``family`` of a
configuration's file. They import nothing of the program."""
