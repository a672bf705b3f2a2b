"""The dry run's DTensor path through one sLSTM layer (xlstm-1.3b's
smoke config) on a real (2, 2) gloo mesh: its output and every
parameter's gradient equal the plain layer's, while its token loop runs
on each rank's own rows (`dtensor_forms.slstm_scan`; the recurrent
weights' gradient is a partial sum over the data ranks). The whole xlstm
model on DTensors takes too long for this file's time budget (DTensor's
sharding rules for the mLSTM's rank-5 products); the fake dry run covers
its shapes. The harness is tests/test_torch_act_sharding.py's."""
from test_torch_act_sharding import run_on_gloo


def test_slstm_dtensor_equals_plain_layer():
    run_on_gloo("slstm", (2, 2), serve=False)
