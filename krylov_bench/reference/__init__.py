"""The plain reference of every configuration and solve the benchmark runs.

Plain PyTorch on whole grids: shifted slices for the operators, textbook
loops for the solvers.  It imports nothing of the program under test and
takes nothing the program built: each operator, factor and solve is worked
out again here from the configuration and the inputs the harness made.
"""
