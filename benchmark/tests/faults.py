"""Faults planted in the timed path, for the tests that must see
``correct`` come out false. Each wraps a function of the program while
installed and is picklable, so that every rank of a sharded run can plant
it."""


class Unchanged:
    """A pivot step that returns its state unchanged."""

    def install(self, solver):
        self.inner = solver.pivot_step
        solver.pivot_step = lambda prob, state, opts, backend, ctl=None: state

    def remove(self, solver):
        solver.pivot_step = self.inner


class Altered:
    """A pivot step whose answer is altered where it is produced: the
    basic value of row 0 moves by 1 after every step."""

    def install(self, solver):
        inner = self.inner = solver.pivot_step

        def step(prob, state, opts, backend, ctl=None):
            new = inner(prob, state, opts, backend, ctl)
            new.x_b = new.x_b.clone()
            new.x_b[0] += 1
            return new

        solver.pivot_step = step

    def remove(self, solver):
        solver.pivot_step = self.inner


class NoExchange:
    """The exchange between ranks left out: every all-reduce of the
    column-sharded solve returns the rank's own tensor."""

    def install(self, solver):
        from simplex_tpu_torch.dist import sharded

        self.inner = sharded.all_reduce

        def all_reduce(t, op, group, name):
            sharded.collectives[name] += 1
            return t

        sharded.all_reduce = all_reduce

    def remove(self, solver):
        from simplex_tpu_torch.dist import sharded

        sharded.all_reduce = self.inner
