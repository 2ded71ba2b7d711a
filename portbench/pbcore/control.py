"""The control of ``correct``: the plain reference with k-mer membership
decided by a 32-bit fingerprint of the code (``reference.py``,
``fingerprinted=True``), put in the program's place.  That breaks the
exactness the configurations state, the step a faster table might take.

``harness.run_cell(root, cell, seed, 0, False, driver=Control(plan.driver))``
runs it as a run of the cell is run and judges its answers by the same
comparison, where it has to come out not correct; its numbers are the upper
readings of the limits.  The benchmark's own runs never take it.
"""


class Control:
    """A driver whose every call answers with the fingerprinted reference
    of the cell's own driver."""

    def __init__(self, driver):
        self.driver = driver
        self.STEP, self.FAMILY = driver.STEP, driver.FAMILY

    def build(self, cell):
        return None

    def warm(self, state, cell) -> None:
        pass

    def call(self, state, cell, i: int) -> int:
        if "control" not in cell.store:
            cell.store["control"] = self.driver.expected(cell, True)[0]
        return 0  # no window of the program's is scanned

    def answers(self, cell, i: int) -> list:
        return cell.store["control"]

    def expected(self, cell, fingerprinted: bool):
        return self.driver.expected(cell, fingerprinted)

    def pack(self, cell):
        return self.driver.pack(cell)
