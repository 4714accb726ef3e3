"""Plain float32 references of what the benchmark's cells run. They import
torch and numpy only: nothing of the program under test."""
