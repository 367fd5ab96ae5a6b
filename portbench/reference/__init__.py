"""Plain PyTorch references; nothing here imports the program under test."""
