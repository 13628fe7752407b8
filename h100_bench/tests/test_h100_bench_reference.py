"""The benchmark's plain reference against the program on the CPU at a
tiny size, from the same drawn weights: DETRPose-L's serving forward and
decode at 160 px."""
import json

import torch

from h100_bench import weights
from h100_bench.reference.models.postprocess import postprocess as ref_postprocess
from h100_bench.run import ROOT


def test_serving_forward_and_decode_match_the_program():
    from detrpose_tpu_torch.configs import build_model, model_config
    from detrpose_tpu_torch.models import postprocess

    cfg = json.loads((ROOT / "h100_bench/configs/detrpose-l-coco.json").read_text())
    ref = weights.reference_net(cfg["model"], 2**31 + 3, "cpu")
    port = build_model(model_config("l", msda_backend="gather"), device="cpu")
    port.load_state_dict(ref.state_dict(), strict=True)
    x = torch.rand(2, 3, 160, 160, generator=torch.Generator().manual_seed(0))
    wh = torch.tensor([[1280.0, 720.0], [640.0, 480.0]])
    with torch.no_grad():
        r, p = ref(x), port(x)
    # float32 both, sums in another order (MSDA by grid_sample against the
    # program's corner gather): within 1e-4 of logits and keypoints near 1
    for k in ("pred_logits", "pred_keypoints"):
        assert (r[k] - p[k]).abs().max() < 1e-4, k
    for a, b in zip(ref_postprocess(p, wh), postprocess(p, wh)):
        assert torch.equal(a, b)
