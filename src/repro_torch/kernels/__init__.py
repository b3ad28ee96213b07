"""Table prep, the plain PyTorch cam_match and its Hopper CUDA kernel."""
