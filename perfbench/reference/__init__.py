"""Plain PyTorch references that decide `correct`. They import nothing of
the port and take nothing that the port made."""
