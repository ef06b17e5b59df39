"""The plain reference of the benchmark: the generation and training math of
ConsistencyTTA in float32 PyTorch, with TF32 off, written apart from the
program it judges. It imports nothing of the port, of JAX or of the JAX
package; it takes the benchmark's seeded weights under the port's state-dict
key names, and the benchmark's inputs, and works out everything else again.

`fake_quant` puts every linear and convolution of a reference model through
float8 (e4m3) at its inputs and weights: the control, one precision below
the bfloat16 that the configurations state.
"""
