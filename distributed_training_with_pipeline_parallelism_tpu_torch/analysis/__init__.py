"""Host-side models of a pipeline step's time and memory, priced from its
compiled tick table (the port's own copies of the numpy parts of the JAX
package's ``analysis/``)."""
