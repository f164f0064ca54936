"""CPU settings for the port's test modules: cheap JAX references, one thread.

A port test holds the plain-torch twins, on a few thousand keys, to the JAX
package's programs run once in interpret mode.  Two defaults make that dear
and buy nothing at these sizes:

- XLA compiling the interpret-mode kernels at full optimisation, nearly all
  of a JAX reference's cost.  ``jax_disable_most_optimizations`` compiles
  the same programs (XLA's backend at level 0, no expensive LLVM passes) to
  the same integer answers for about half the CPU.
- torch's intra-op thread pool.  On tensors of ~10^5 elements its threads
  mostly wait for each other, the more so beside the other test workers;
  one thread gives the same answers for a fraction of the CPU.

A test module that imports ``lean_cpu`` runs its tests under both.  Both
are restored after the module's last test, so the JAX package's own tests
run as they always have.
"""

import jax
import pytest
import torch

_FLAG = "jax_disable_most_optimizations"


@pytest.fixture(scope="module", autouse=True)
def lean_cpu():
    flag, threads = jax.config.read(_FLAG), torch.get_num_threads()
    jax.config.update(_FLAG, True)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update(_FLAG, flag)
