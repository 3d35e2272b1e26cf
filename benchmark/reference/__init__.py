"""Plain references that decide ``correct``, and the frozen scene generator.

Nothing here imports the program (``minipath_tpu_torch``), JAX or the JAX
package: a reference works out again what the program derives, from the
same inputs.
"""
