"""Video-QA and multiple-choice metrics, host-side numpy (copy of
demovlp_tpu/metrics/qa.py)."""
from __future__ import annotations

import numpy as np

ANSWER_TYPES = ("what", "who", "how", "where", "when", "object", "number", "color",
                "location")


def evaluate_qa(results, label2ans, qid2data):
    """Overall and per-answer-type accuracy.

    results: [{"question_id": int, "answer": int label}]; label2ans:
    {label: answer}; qid2data: {question_id: {"answer", "answer_type"}}."""
    answer_type2idx = {k: idx for idx, k in enumerate(ANSWER_TYPES)}
    preds, gts, answer_types = [], [], []
    qid2pred_ans = {r["question_id"]: label2ans[r["answer"]] for r in results}
    for qid, pred_ans in qid2pred_ans.items():
        preds.append(pred_ans)
        gt_data = qid2data[qid]
        answer_types.append(answer_type2idx[gt_data["answer_type"]])
        gts.append(gt_data["answer"])
    preds, gts, answer_types = np.array(preds), np.array(gts), np.array(answer_types)
    metrics = {"overall_acc": float(np.mean(preds == gts))}
    ratios = {}
    for ans_type, ans_type_idx in answer_type2idx.items():
        mask = answer_types == ans_type_idx
        corrects = preds[mask] == gts[mask]
        metrics[f"{ans_type}_acc"] = float(np.mean(corrects)) if len(corrects) != 0 else 0
        ratios[f"{ans_type}_ratio"] = [1.0 * len(corrects) / len(answer_types), len(corrects)]
    metrics["ratios"] = ratios
    return metrics


def evaluate_mc(pred_id2answer, gt_id2answer):
    """Multiple-choice accuracy over the predicted ids, as a percentage
    string."""
    shared_ids = list(pred_id2answer.keys())
    gt_answers = np.array([gt_id2answer[k] for k in shared_ids])
    pred_answers = np.array([pred_id2answer[k] for k in shared_ids])
    acc = np.mean(gt_answers == pred_answers)
    return dict(mc_accuracy=f"{100 * acc:.2f}")


METRICS = {fn.__name__: fn for fn in (evaluate_qa, evaluate_mc)}
