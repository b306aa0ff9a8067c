"""Plain references of the benchmarked models, one module per architecture
family; plain PyTorch, nothing of the program under test."""
