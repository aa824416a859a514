"""The port's hand-written Hopper kernels (CUDA C++ and Triton), their
plain PyTorch versions, and the device dispatch in `ops`."""
