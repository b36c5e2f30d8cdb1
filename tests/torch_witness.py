"""The port's lock-order witness and transfer guard, armed around a test.

A serving suite imports :func:`port_witness` (an autouse fixture) to run
each of its tests under a fresh ``veles_tpu_torch.serving.lockcheck``
witness and the armed ``xfer`` guard (``"disallow"``).  On the CPU the
guard never touches the card's sync debug mode (a CPU engine's guard is
a null context), so there it checks the shims' bookkeeping; the lock
witness checks every acquisition and dispatch site.  Teardown fails the
test on any recorded violation, with both stacks.  The reference's own
witnesses live in ``tests/conftest.py`` and are armed only around its
suites.
"""

import pytest

from veles_tpu_torch.serving import lockcheck, xfer


@pytest.fixture(autouse=True)
def port_witness(request):
    name = request.node.nodeid
    witness = lockcheck.LockOrderWitness(name="torch_witness:%s" % name)
    lockcheck.arm(witness)
    xfer.arm("disallow")
    try:
        yield witness
    finally:
        xfer.disarm()
        lockcheck.disarm()
    assert not witness.violations, (
        "lock-order witness recorded %d violation(s) during %s:\n\n%s"
        % (len(witness.violations), name,
           "\n\n".join(witness.violations)))
