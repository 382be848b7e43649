"""Plain references the benchmark holds the program's outputs to.

Plain PyTorch, float32 with TF32 off unless a caller asks for the lower
precision of a control. Nothing here imports the program, JAX or the JAX
package, or takes anything the program made.
"""
