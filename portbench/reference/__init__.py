"""The benchmark's plain reference: the two segmentation networks, their
sparse-label training step, evaluation and the margin-sampling pick, in
plain PyTorch on a weight dict. It imports torch and numpy only, nothing of
the program under test and nothing of JAX."""
