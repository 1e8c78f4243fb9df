"""The plain reference the benchmark judges the program by: float64 NumPy
products, and the frozen rules that make the benchmark's inputs. Imports
nothing of the program."""
