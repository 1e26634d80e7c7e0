"""A cell of BENCHMARK.json cut to a size a CPU test can hold: the same
configuration keys, flags and traffic, smaller counts and widths."""

import copy

from kgbench.spec import load_cell

# a norm over a few hundred elements averages rounding far less than one
# over millions: at this size the training limits sit between the CPU
# port's readings (under 1e-7) and the faults' (above 1e-2)
TINY_TRAIN_LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-5, "change_gap": 1e-5,
                     "replay_loss_gap": 1e-3, "replay_state_gap": 1e-5,
                     "replay_change_gap": 1e-5}


def tiny_cell(workload: str):
    cell = load_cell(workload)
    conf = copy.deepcopy(cell.config)
    conf.update(n_entities=300, n_relations=20, n_train=4000, n_valid=200,
                n_test=300)
    conf["flags"].update(hidden_dim=8 if cell.family == "rescal" else 16,
                         batch_size=40, neg_sample_size=10, log_interval=40)
    traffic = copy.deepcopy(cell.traffic)
    traffic.update(warm_seconds=0.1, trace_groups=3)
    cell.config, cell.traffic = conf, traffic
    cell.limits = dict(TINY_TRAIN_LIMITS)
    return cell


def tiny_transr_cell():
    """A TransR cell (a spec.Cell that no BENCHMARK.json entry names):
    dgl-ke's FB15k TransR recipe (examples/fb15k.sh: gamma 8, lr 0.015,
    -rc 5e-8, -adv) at the tiny size, under the train mix."""
    cell = tiny_cell("fb15k-transe_l2.train")
    cell.name = "tiny-transr.train"
    cell.config.update(name="tiny-transr", family="transr")
    cell.config["flags"].update(model_name="TransR", hidden_dim=8,
                                gamma=8.0, lr=0.015,
                                regularization_coef=5e-8)
    cell.per_layer, cell.readers = [], {}
    return cell
