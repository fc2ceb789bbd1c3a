"""`python -m hirest_tpu_torch.evaluate --task ... --pred_data ...`: the
port's evaluator, with the flags of the root evaluate.py (the reference
evaluator's); see hirest_tpu_torch/eval/cli.py."""

from hirest_tpu_torch.eval.cli import main

if __name__ == "__main__":
    main()
