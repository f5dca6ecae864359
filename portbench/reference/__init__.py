"""The plain reference of what a served query answers, in float64 PyTorch.

It imports nothing of the program and takes nothing the program made: it
works the answers out again from the gallery and the queries that the
benchmark generated and handed to both sides.
"""
