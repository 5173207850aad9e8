"""Faults planted in the port, for the upper readings of a number that
the control does not move (calibrate.py --fault) and for the tests that
see such a fault come out not correct. Each takes `assign`, which sets an
attribute: setattr, or a test's monkeypatch.setattr to undo it.

  mode_draws  Gibbs takes each component's and each stick's posterior
              mode where it should draw them.
"""


def mode_draws(assign=setattr):
    from harness import port as harness_port
    from mimo_tpu_torch.distributions import niw
    from mimo_tpu_torch.distributions.gating import StickBreaking
    init = harness_port.Port.__init__

    def planted(self, config, device):
        init(self, config, device)
        self.model.family = self.model.family._replace(
            sample_params=lambda gen, q: niw.mode_params(q))
    assign(harness_port.Port, '__init__', planted)
    assign(StickBreaking, 'sample', lambda sticks, gen: sticks.mode())


FAULTS = {'mode_draws': mode_draws}
