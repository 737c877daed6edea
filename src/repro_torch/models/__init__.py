"""CTR models (LR / FM / DNN) in PyTorch."""
