"""The four networks as nn.Modules with the checkpoint's names."""
