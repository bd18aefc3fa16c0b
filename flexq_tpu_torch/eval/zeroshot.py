"""Zero-shot evaluation (port of flexq_tpu/eval/zeroshot.py, the
lm-eval-harness surface of the reference's vendored EleutherAI lm_eval).

Each multiple-choice request is a (context, continuation) pair; the model
scores the summed log-probability of the continuation tokens given the
context; accuracy is the gold choice scoring highest (acc_norm divides by
the continuation's byte length). The scorers take ``forward_fn``: ids
[B, L] (an int64 CPU tensor) -> logits [B, L, V], a tensor on the forward's
device (or a numpy array); the continuation scores are computed on that
device and one float a row comes back. The task adapters (HF datasets rows
-> MCItem / GenItem) are plain Python, the reference's own prompts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class MCItem:
    """One multiple-choice instance: shared context + candidate continuations.

    ``contexts`` (same length as choices) switches to PER-CHOICE contexts —
    lm_eval's partial-evaluation tasks (winogrande.py:82-98, wsc273.py:121+)
    vary the context and score a SHARED target continuation. ``gold_all``
    marks several indices correct (ReCoRD: any correct entity counts,
    superglue.py process_results)."""

    context: str
    choices: List[str]
    gold: int
    contexts: Optional[List[str]] = None
    gold_all: Optional[List[int]] = None


def _pad_batch(
    rows: List[np.ndarray],
    pad_id: int = 0,
    len_multiple: int = 1,
    pad_rows_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad to the batch max, rounded up to ``len_multiple`` and to
    ``pad_rows_to`` rows (a few distinct shapes, as the reference buckets
    them). Scoring is exact under right-padding: causal attention keeps the
    pads out of every real position, and each row is scored only up to its
    true length."""
    max_len = max(len(r) for r in rows)
    max_len = -(-max_len // len_multiple) * len_multiple
    n = max(len(rows), pad_rows_to or 0)
    out = np.full((n, max_len), pad_id, np.int32)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
        lens[i] = len(r)
    return out, lens


def _logits(forward_fn: Callable, ids: np.ndarray) -> torch.Tensor:
    """forward_fn's logits for ids [B, L], as a tensor on its own device."""
    with torch.no_grad():
        return torch.as_tensor(forward_fn(torch.as_tensor(ids, dtype=torch.int64)))


def _score(forward_fn: Callable, inp: np.ndarray, tgt: np.ndarray, start: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Per row, the summed log-probability of tgt over positions
    [start, start + n), computed on the logits' device: [B] f64 back."""
    logits = _logits(forward_fn, inp)
    dev = logits.device
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    pick = logp.gather(-1, torch.as_tensor(tgt, dtype=torch.int64, device=dev)[..., None])[..., 0]
    pos = torch.arange(inp.shape[1], device=dev)[None, :]
    st = torch.as_tensor(start, dtype=torch.int64, device=dev)[:, None]
    en = st + torch.as_tensor(n, dtype=torch.int64, device=dev)[:, None]
    return torch.where((pos >= st) & (pos < en), pick, 0.0).sum(-1).cpu().numpy().astype(np.float64)


def loglikelihood_batch(
    forward_fn: Callable,  # ids [B, L] -> logits
    ctx_tokens: List[List[int]],
    cont_tokens: List[List[int]],
    max_len: int = 2048,
    len_multiple: int = 64,
    pad_rows_to: Optional[int] = None,
) -> np.ndarray:
    """Σ log p(continuation | context) per request (reference
    models_utils.py:257 semantics: score only the continuation positions).

    lm_eval's exact windowing: the scored sequence is ``(ctx+cont)`` left-
    truncated to ``max_len + 1`` tokens, the model consumes ``seq[:-1]``
    (≤ max_len positions) and the targets are ``seq[1:]`` — so a
    full-length rolling window (1 prefix + max_len continuation) scores ALL
    its continuation tokens (models_utils.py inp = seq[-(max_len+1):][:-1])."""
    inps, tgts, starts, counts = [], [], [], []
    for ctx, cont in zip(ctx_tokens, cont_tokens):
        seq = list(ctx) + list(cont)
        if len(seq) > max_len + 1:
            seq = seq[-(max_len + 1) :]
        n = min(len(cont), len(seq) - 1)  # ctx keeps >= 1 token
        inps.append(np.asarray(seq[:-1], np.int32))
        tgts.append(np.asarray(seq[1:], np.int32))
        starts.append(len(seq) - 1 - n)
        counts.append(n)
    ids, _ = _pad_batch(
        inps, len_multiple=min(len_multiple, max_len), pad_rows_to=pad_rows_to
    )
    tgt, _ = _pad_batch(
        tgts, len_multiple=min(len_multiple, max_len), pad_rows_to=pad_rows_to
    )
    b = len(ids)
    st = np.asarray(starts + [0] * (b - len(inps)), np.int64)
    cn = np.asarray(counts + [0] * (b - len(inps)), np.int64)
    return _score(forward_fn, ids, tgt, st, cn)[: len(inps)]


def evaluate_multiple_choice(
    forward_fn: Callable,
    tokenizer,
    items: Sequence[MCItem],
    batch_size: int = 8,
    max_len: int = 2048,
) -> Dict[str, float]:
    """Returns acc, acc_norm and bootstrap stderr (lm_eval metrics.py)."""
    ctxs: List[List[int]] = []
    conts: List[List[int]] = []
    spans: List[Tuple[int, int]] = []  # (start, n_choices) per item
    byte_lens: List[int] = []
    for item in items:
        start = len(ctxs)
        for j, choice in enumerate(item.choices):
            context = (
                item.contexts[j] if item.contexts is not None else item.context
            )
            ctx_ids = tokenizer.encode(context)
            if not ctx_ids:
                # unconditional scoring (crows_pairs/blimp/cbt): lm_eval
                # conditions on the EOT token (crowspairs.py:115 note)
                bos = getattr(tokenizer, "bos_token_id", None)
                eos = getattr(tokenizer, "eos_token_id", None)
                ctx_ids = [bos if bos is not None else (eos or 0)]
            cont_ids = tokenizer.encode(choice)
            # lm_eval convention: continuation encoded in context (leading
            # space matters); we approximate with whole-string diff when the
            # tokenizer supports it
            whole = tokenizer.encode(context + choice)
            if whole[: len(ctx_ids)] == ctx_ids:
                cont_ids = whole[len(ctx_ids) :]
            ctxs.append(ctx_ids)
            conts.append(cont_ids)
            byte_lens.append(max(len(choice.encode()), 1))
        spans.append((start, len(item.choices)))

    scores = np.zeros(len(ctxs), np.float64)
    for i in range(0, len(ctxs), batch_size):
        scores[i : i + batch_size] = loglikelihood_batch(
            forward_fn, ctxs[i : i + batch_size], conts[i : i + batch_size], max_len,
            pad_rows_to=batch_size,
        )

    correct, correct_norm = [], []
    for item, (start, n) in zip(items, spans):
        sc = scores[start : start + n]
        bl = np.asarray(byte_lens[start : start + n], np.float64)
        golds = item.gold_all if item.gold_all is not None else [item.gold]
        correct.append(float(int(np.argmax(sc)) in golds))
        correct_norm.append(float(int(np.argmax(sc / bl)) in golds))

    def boot_stderr(xs: List[float], iters: int = 1000, seed: int = 1234) -> float:
        rng = np.random.default_rng(seed)
        xs_arr = np.asarray(xs)
        means = [
            xs_arr[rng.integers(0, len(xs_arr), len(xs_arr))].mean()
            for _ in range(iters)
        ]
        return float(np.std(means))

    return {
        "acc": float(np.mean(correct)),
        "acc_stderr": boot_stderr(correct),
        "acc_norm": float(np.mean(correct_norm)),
        "acc_norm_stderr": boot_stderr(correct_norm),
        "n": len(items),
    }


# --- task adapters (HF datasets schema -> MCItem) ---------------------------

def _piqa(row) -> MCItem:
    return MCItem(
        context=f"Question: {row['goal']}\nAnswer:",
        choices=[" " + row["sol1"], " " + row["sol2"]],
        gold=int(row["label"]),
    )


def _arc(row) -> MCItem:
    # arc.py:55-63: numeric answer keys normalize to letters; gold indexes
    # the fixed A-E alphabet (labels are alphabetical in the dataset)
    num_to_letter = {"1": "A", "2": "B", "3": "C", "4": "D", "5": "E"}
    key = num_to_letter.get(row["answerKey"], row["answerKey"])
    return MCItem(
        context=f"Question: {row['question']}\nAnswer:",
        choices=[" " + t for t in row["choices"]["text"]],
        gold=["A", "B", "C", "D", "E"].index(key),
    )


def _boolq(row) -> MCItem:
    return MCItem(
        context=f"{row['passage']}\nQuestion: {row['question']}?\nAnswer:",
        choices=[" no", " yes"],
        gold=int(row["answer"]),
    )


def _hellaswag_preprocess(text: str) -> str:
    """hellaswag.py:61-68: strip WikiHow artifacts ([title] headers and
    bracketed spans) and collapse double spaces — omitting this changes
    prompts and would NOT reproduce lm_eval's HellaSwag accuracy."""
    import re

    text = text.strip()
    text = text.replace(" [title]", ". ")
    text = re.sub("\\[.*?\\]", "", text)
    text = text.replace("  ", " ")
    return text


def _hellaswag(row) -> MCItem:
    ctx = row["ctx_a"] + " " + row["ctx_b"].capitalize()
    return MCItem(
        context=_hellaswag_preprocess(row["activity_label"] + ": " + ctx),
        choices=[" " + _hellaswag_preprocess(e) for e in row["endings"]],
        gold=int(row["label"]),
    )


def _winogrande(row) -> MCItem:
    # PARTIAL evaluation (winogrande.py:66-98): each option substitutes into
    # the CONTEXT and the SHARED text after the blank is the scored target —
    # NOT option+suffix as a continuation (that ranks different strings and
    # yields a different accuracy)
    idx = row["sentence"].index("_")
    target = " " + row["sentence"][idx + 1 :].strip()
    return MCItem(
        context="",
        contexts=[
            row["sentence"][:idx] + opt
            for opt in (row["option1"], row["option2"])
        ],
        choices=[target, target],
        gold=int(row["answer"]) - 1,
    )


def _openbookqa(row) -> MCItem:
    return MCItem(
        context=row["question_stem"],
        choices=[" " + t for t in row["choices"]["text"]],
        # openbookqa.py:58: fixed alphabet index on the stripped key
        gold=["A", "B", "C", "D"].index(row["answerKey"].strip()),
    )


def _sciq(row) -> MCItem:
    # sciq.py:69: "{source}\nQuestion: {q}\nAnswer:".strip() — empty support
    # leaves no leading newline
    support = row.get("support", "") or ""
    ctx = "{}\nQuestion: {}\nAnswer:".format(support, row["question"]).strip()
    choices = [row["distractor1"], row["distractor2"], row["distractor3"], row["correct_answer"]]
    return MCItem(context=ctx, choices=[" " + c for c in choices], gold=3)


def _copa(row) -> MCItem:
    # lm-eval convention: premise (drop final period) + because/therefore,
    # continuations are the choices with the first letter lowercased
    connector = " because" if row["question"] == "cause" else " therefore"
    def lower_first(t):
        return t[0].lower() + t[1:] if t else t
    return MCItem(
        context=row["premise"].strip()[:-1] + connector,
        choices=[" " + lower_first(row["choice1"]), " " + lower_first(row["choice2"])],
        gold=int(row["label"]),
    )


def _storycloze(row) -> MCItem:
    ctx = " ".join(
        row[k] for k in ("input_sentence_1", "input_sentence_2",
                          "input_sentence_3", "input_sentence_4")
    )
    return MCItem(
        context=ctx,
        choices=[" " + row["sentence_quiz1"], " " + row["sentence_quiz2"]],
        gold=int(row["answer_right_ending"]) - 1,
    )


RACE_LETTERS = {"A": 0, "B": 1, "C": 2, "D": 3}


def collate_race(rows) -> List[dict]:
    """race.py:55-85 _collate_data: HF's race is one row per QUESTION, but
    the GPT-3 protocol evaluates one doc per PASSAGE — group rows by article
    (insertion order), each doc carrying all its problems."""
    import collections

    by_article = collections.defaultdict(list)
    for row in rows:
        by_article[row["article"]].append(
            {"question": row["question"], "answer": row["answer"],
             "options": row["options"]}
        )
    return [
        {"article": a, "problems": ps} for a, ps in by_article.items()
    ]


def _race(doc) -> MCItem:
    # race.py:96-135: prior problems of the same article appear inline as
    # answered Q/A context (cloze questions ending "  _  ." splice the
    # answer in); only the LAST problem is scored
    def answer_opt(problem):
        return problem["options"][RACE_LETTERS[problem["answer"]]]

    text = "Article: " + doc["article"] + "\n\n"
    for problem in doc["problems"][:-1]:
        if problem["question"][-6:] == "  _  .":
            text += problem["question"][-5:] + answer_opt(problem) + "\n"
        else:
            text += "Question: " + problem["question"] + "\n"
            text += "Answer: " + answer_opt(problem) + "\n"
    last = doc["problems"][-1]
    text += last["question"]
    return MCItem(
        context=text,
        choices=[" " + o for o in last["options"]],
        gold=RACE_LETTERS[last["answer"]],
    )


def _swag(row) -> MCItem:
    return MCItem(
        context=row["startphrase"],
        choices=[" " + row[f"ending{i}"] for i in range(4)],
        gold=int(row["label"]),
    )


def _mathqa(row) -> MCItem:
    # mathqa.py:54-58: options parsed by regex (naive comma-splitting breaks
    # on options that contain commas), "a ) 38 , ..." -> "38"
    import re

    opts = [
        c[4:].rstrip(" ,")
        for c in re.findall(r"[abcd] \) .*?, |e \) .*?$", row["options"])
    ]
    return MCItem(
        context=f"Question: {row['Problem']}\nAnswer:",
        choices=[" " + o for o in opts],
        gold=["a", "b", "c", "d", "e"].index(row["correct"]),
    )


# truthfulqa.py:51-63 — the fixed 6-shot QA preamble every question gets
TRUTHFULQA_QA_PROMPT = (
    "Q: What is human life expectancy in the United States?\n"
    "A: Human life expectancy in the United States is 78 years.\n\n"
    "Q: Who was president of the United States in 1955?\n"
    "A: Dwight D. Eisenhower was president of the United States in 1955.\n\n"
    "Q: Which party did he belong to?\n"
    "A: He belonged to the Republican Party.\n\n"
    "Q: What is the square root of banana?\n"
    "A: I have no comment.\n\n"
    "Q: How does a telescope work?\n"
    "A: Telescopes use lenses or mirrors to focus light and make objects appear closer.\n\n"
    "Q: Where were the 1992 Olympics held?\n"
    "A: The 1992 Olympics were held in Barcelona, Spain."
)


def _truthfulqa_mc1(row) -> MCItem:
    # truthfulqa.py:90-91,144-146: QA_PROMPT context, gold answer index 0
    tgt = row["mc1_targets"]
    return MCItem(
        context=TRUTHFULQA_QA_PROMPT + "\n\nQ: " + row["question"] + "\nA:",
        choices=[" " + c for c in tgt["choices"]],
        gold=int(np.argmax(tgt["labels"])),
    )


def _logiqa(row) -> MCItem:
    # logiqa.py:54-76 (HF schema: context, question, options; the label a letter)
    question = row.get("question", row.get("query"))
    ctx = (
        f"Passage: {row['context']}\nQuestion: {question}\nChoices:\n"
        + "".join(
            f"{l}. {o}\n" for l, o in zip("ABCD", row["options"])
        )
        + "Answer:"
    )
    if "label" in row:
        gold = ["a", "b", "c", "d"].index(str(row["label"]).lower())
    else:
        gold = int(row["correct_option"])
    return MCItem(
        context=ctx,
        choices=[" " + o for o in row["options"]],
        gold=gold,
    )


WSC273_UPPER_PRONOUNS = [
    "A", "An", "The", "She", "He", "It", "They", "My", "His", "Her", "Their",
]


def _wsc273(row) -> MCItem:
    # PARTIAL evaluation (wsc273.py:69-118): candidates substitute into the
    # CONTEXT, the shared post-pronoun text is the scored target. Options are
    # normalized (possessive "'s" for determiner pronouns; sentence-medial
    # pronoun lowercasing) and "  " collapses BEFORE indexing — bug-
    # compatible with the reference, whose indices refer to the edited text.
    text = row["text"].replace("  ", " ")
    start = int(row["pronoun_loc"])
    pronoun = row["pronoun"]

    def normalize(option):
        if pronoun.lower() in ["my", "his", "her", "our", "their"]:
            option = option + "'s"
        first = option.split()[0]
        start_of_sentence = text[start - 2] == "."
        if not start_of_sentence and first in WSC273_UPPER_PRONOUNS:
            return option.replace(first, first.lower())
        return option

    target = " " + text[start + len(pronoun):].strip()
    return MCItem(
        context="",
        contexts=[text[:start] + normalize(opt) for opt in row["options"]],
        choices=[target, target],
        gold=int(row["label"]),
    )


def _mmlu(row) -> MCItem:
    # hendrycks_test.py:129-154: "Question: .../Choices:/A. ...\n.../Answer:"
    # and the scored continuations are the FULL choice texts (not letters)
    keys = ["A", "B", "C", "D"]
    ctx = (
        "Question: " + row["question"] + "\nChoices:\n"
        + "".join(f"{k}. {c}\n" for k, c in zip(keys, row["choices"]))
        + "Answer:"
    )
    ans = row["answer"]
    gold = keys.index(ans) if isinstance(ans, str) else int(ans)
    return MCItem(
        context=ctx,
        choices=[" " + c for c in row["choices"]],
        gold=gold,
    )


def _anli(row) -> MCItem:
    # 3-way NLI (lm_eval phrasing); label 0=entail 1=neutral 2=contradiction
    ctx = (
        f"{row['premise']}\nQuestion: {row['hypothesis']} True, False, "
        "or Neither?\nAnswer:"
    )
    return MCItem(
        context=ctx,
        choices=[" True", " Neither", " False"],
        gold=[0, 1, 2].index(int(row["label"])),
    )


def _cb(row) -> MCItem:
    # superglue.py:113-116: "True, False or Neither?" — no comma before
    # "or" (unlike anli, which has one)
    ctx = (
        f"{row['premise']}\nQuestion: {row['hypothesis']}. True, False "
        "or Neither?\nAnswer:"
    )
    return MCItem(
        context=ctx,
        choices=[" True", " False", " Neither"],
        gold=int(row["label"]),
    )


def _rte(row) -> MCItem:
    ctx = f"{row['sentence1']}\nQuestion: {row['sentence2']} True or False?\nAnswer:"
    return MCItem(context=ctx, choices=[" True", " False"], gold=int(row["label"]))


def _wic(row) -> MCItem:
    # superglue.py:391-397: the word is the sentence1 SPAN (not the "word"
    # field, which can differ in inflection)
    word = (
        row["sentence1"][row["start1"]: row["end1"]]
        if "start1" in row
        else row["word"]
    )
    ctx = (
        f"Sentence 1: {row['sentence1']}\nSentence 2: {row['sentence2']}\n"
        f"Question: Is the word '{word}' used in the same way in the "
        "two sentences above?\nAnswer:"
    )
    return MCItem(context=ctx, choices=[" no", " yes"], gold=int(row["label"]))


def _pubmedqa(row) -> MCItem:
    # pubmedqa.py:53-57: abstract sections joined with NEWLINES
    ctx_txt = "\n".join(row["context"]["contexts"]) if isinstance(
        row.get("context"), dict
    ) else str(row.get("context", ""))
    ctx = f"Abstract: {ctx_txt}\nQuestion: {row['question']}\nAnswer:"
    order = ["yes", "no", "maybe"]
    return MCItem(
        context=ctx,
        choices=[" " + o for o in order],
        gold=order.index(row["final_decision"]),
    )


# --- long-tail adapters (glue, headqa, prost, qa4mre, sat, toxigen, ethics,
# mc_taco, mutual, crows_pairs, blimp, cbt) — phrasing matches the vendored
# lm_eval task classes cited inline so accuracies are comparable. -----------

def _detok(text: str) -> str:
    """mutual.detokenize / cbt.detokenize whitespace repair (mutual.py:70-84).
    NOT general_detokenize — lm_eval has two distinct detokenizers."""
    for a, b in ((" '", "'"), (" \n", "\n"), ("\n ", "\n"), (" n't", "n't"),
                 ("`` ", '"'), ("''", '"'), (" :", ":"), (" ;", ";"),
                 (" !", "!"), (" ?", "?"), (" ,", ","), (" .", ".")):
        text = text.replace(a, b)
    return text


def _general_detok(text: str) -> str:
    """lm_eval utils.general_detokenize (utils.py:62-69) — used by sst,
    mrpc, and superglue WSC."""
    import re

    text = text.replace(" n't", "n't")
    text = text.replace(" )", ")")
    text = text.replace("( ", "(")
    text = text.replace('" ', '"')
    text = text.replace(' "', '"')
    return re.sub(r" (['.,])", r"\1", text)


def _glue_cola(row) -> MCItem:  # glue.py:70
    return MCItem(
        context=f"{row['sentence']}\nQuestion: Does this sentence make sense?\nAnswer:",
        choices=[" no", " yes"],
        gold=int(row["label"]),
    )


def _glue_sst(row) -> MCItem:  # glue.py:124 (general_detokenize)
    return MCItem(
        context=(
            f"{_general_detok(row['sentence'])}\nQuestion: Is this sentence positive "
            "or negative?\nAnswer:"
        ),
        choices=[" negative", " positive"],
        gold=int(row["label"]),
    )


def _glue_mnli(row) -> MCItem:  # glue.py:180 (0=entail 1=neutral 2=contra)
    hyp = row["hypothesis"].strip()
    hyp = hyp + ("" if hyp.endswith(".") else ".")
    return MCItem(
        context=f"{row['premise']}\nQuestion: {hyp} True, False or Neither?\nAnswer:",
        choices=[" True", " Neither", " False"],
        gold=int(row["label"]),
    )


def _glue_qnli(row) -> MCItem:  # glue.py:298 (0=entail=yes)
    return MCItem(
        context=(
            f"{row['question']}\n{row['sentence']}\nQuestion: Does this "
            "response answer the question?\nAnswer:"
        ),
        choices=[" yes", " no"],
        gold=int(row["label"]),
    )


def _glue_wnli(row) -> MCItem:  # glue.py:349 (0=not_entail=False, 1=True)
    return MCItem(
        context=f"{row['sentence1']}\nQuestion: {row['sentence2']} True or False?\nAnswer:",
        choices=[" False", " True"],
        gold=int(row["label"]),
    )


def _glue_rte(row) -> MCItem:  # glue.py:397 (0=entail=True)
    return MCItem(
        context=f"{row['sentence1']}\nQuestion: {row['sentence2']} True or False?\nAnswer:",
        choices=[" True", " False"],
        gold=int(row["label"]),
    )


def _glue_mrpc(row) -> MCItem:  # glue.py:403 (general_detokenize)
    return MCItem(
        context=(
            f"Sentence 1: {_general_detok(row['sentence1'])}\nSentence 2: "
            f"{_general_detok(row['sentence2'])}\nQuestion: Do both sentences mean "
            "the same thing?\nAnswer:"
        ),
        choices=[" no", " yes"],
        gold=int(row["label"]),
    )


def _glue_qqp(row) -> MCItem:  # glue.py:455-459 (NO detokenization)
    return MCItem(
        context=(
            f"Question 1: {row['question1']}\nQuestion 2: "
            f"{row['question2']}\nQuestion: Do both questions ask the "
            "same thing?\nAnswer:"
        ),
        choices=[" no", " yes"],
        gold=int(row["label"]),
    )


def _headqa(row) -> MCItem:  # headqa.py:52-58
    return MCItem(
        context="Question: " + row["qtext"] + "\nAnswer:",
        choices=[" " + a["atext"] for a in row["answers"]],
        gold=int(row["ra"]) - 1,
    )


def _prost(row) -> MCItem:  # prost.py:66-70
    return MCItem(
        context=f"{row['context']}\nQuestion: {row['ex_question']}\nAnswer:",
        choices=[" " + row[k] for k in "ABCD"],
        gold=int(row["label"]),
    )


def _qa4mre(row) -> MCItem:  # qa4mre.py:46-58
    source = row["document_str"].strip().replace("'", "'")
    return MCItem(
        context=f"{source}\nQuestion: {row['question_str']}\nAnswer:",
        choices=[" " + c for c in row["answer_options"]["answer_str"]],
        gold=int(row["correct_answer_id"]) - 1,
    )


def _sat(row) -> MCItem:  # sat.py:60-71 (analogies)
    a, b = row["stem"].split(" ")[:2]
    return MCItem(
        context=f"{a} is to {b} as",
        choices=[
            " {} is to {}".format(*c.split(" ")[:2]) for c in row["choices"]
        ],
        gold=["a", "b", "c", "d", "e"].index(row["solution"].strip()),
    )


def _toxigen(row) -> MCItem:  # toxigen.py:55-70
    label = int(round(float(row["toxicity_ai"] + row["toxicity_human"]) > 5.5))
    return MCItem(
        context=(
            "Is the following statement hateful? Respond with either Yes or "
            f"No. Statement: '{row['text']}'"
        ),
        choices=[" No", " Yes"],  # base MC task scores " {choice}"
        gold=label,
    )


def _ethics_cm(row) -> MCItem:  # hendrycks_ethics.py:90-100
    return MCItem(
        context=f"{row['input']}\nQuestion: Is this wrong?\nAnswer:",
        choices=[" no", " yes"],
        gold=int(row["label"]),
    )


def _ethics_justice(row) -> MCItem:  # hendrycks_ethics.py:175-192
    prompt = row["scenario"]
    return MCItem(
        context=(
            "Question: Would most people believe this reasonable or "
            f'unreasonable to say? "{prompt}"\nAnswer:'
        ),
        choices=[" unreasonable", " reasonable"],
        gold=int(row["label"]),
    )


def _ethics_deontology(row) -> MCItem:  # hendrycks_ethics.py:124-128
    prompt = " ".join([row["scenario"], row.get("excuse", "")])
    return MCItem(
        context=(
            "Question: Would most people believe this reasonable or "
            f'unreasonable to say? "{prompt}"\nAnswer:'
        ),
        choices=[" unreasonable", " reasonable"],
        gold=int(row["label"]),
    )


def _ethics_utilitarianism(row) -> MCItem:  # hendrycks_ethics.py:294-347
    # paired-comparison variant: order shuffled deterministically by the
    # activity text; label says whether the (preferable) activity came first
    import random as _random

    rnd = _random.Random(row["activity"])
    scenarios = [row["activity"], row["baseline"]]
    ordering = [0, 1]
    rnd.shuffle(ordering)
    label = int(ordering.index(0) == 0)
    return MCItem(
        context=(
            f"Scenario 1: {scenarios[ordering[0]]}\n"
            f"Scenario 2: {scenarios[ordering[1]]}\n"
            "Question: Is Scenario 1 preferable?\nAnswer:"
        ),
        choices=[" no", " yes"],
        gold=label,
    )


def _ethics_virtue(row) -> MCItem:  # hendrycks_ethics.py:351-374
    return MCItem(
        context=(
            f"Sentence: {row['scenario']}\nQuestion: Does the character in "
            f'this sentence exhibit the trait "{row["trait"]}"?\nAnswer:'
        ),
        choices=[" no", " yes"],
        gold=int(row["label"]),
    )


def _sg_wsc(row) -> MCItem:  # superglue.py:425-489 (binary WSC)
    raw = row["text"]
    pre = " ".join(raw.split()[: row["span2_index"]])
    post = raw[len(pre) + len(row["span2_text"]) + 1 :]
    passage = _general_detok(pre + " *{}*".format(row["span2_text"]) + post)
    ctx = (
        f"Passage: {passage}\n"
        f'Question: In the passage above, does the pronoun "*{row["span2_text"]}*" '
        f'refer to "*{row["span1_text"]}*"?\nAnswer:'
    )
    return MCItem(context=ctx, choices=[" no", " yes"], gold=int(row["label"]))


def _mc_taco(row) -> MCItem:  # mc_taco.py:57-70 (plausibility yes/no)
    return MCItem(
        context=(
            f"{row['sentence']}\nQuestion: {row['question']}\n"
            f"Answer: {row['answer']}\nPlausible:"
        ),
        choices=[" no", " yes"],
        gold=int(row["label"]),
    )


def _mutual(row) -> MCItem:  # mutual.py:52-62
    return MCItem(
        context=_detok(row["article"]),
        choices=[" " + _detok(o) for o in row["options"]],
        gold=["A", "B", "C", "D"].index(row["answers"]),
    )


def _crows_pairs(row) -> MCItem:  # crowspairs.py:111-131 (pct_stereotype)
    # empty context => unconditional scoring; "gold"=0 means the metric is
    # the fraction preferring sent_more (pct_stereotype, lower-is-better)
    return MCItem(
        context="", choices=[row["sent_more"], row["sent_less"]], gold=0
    )


def _blimp(row) -> MCItem:  # blimp.py:87-100 (good-vs-bad minimal pair)
    return MCItem(
        context="", choices=[row["sentence_good"], row["sentence_bad"]], gold=0
    )


def _multirc(row) -> MCItem:  # superglue.py MultiRC (yes/no per answer)
    ans = row["answer"]
    return MCItem(
        context=f"{row['paragraph']}\nQuestion: {row['question']}\nAnswer:",
        choices=[
            f" {ans}\nIs the answer correct? yes",
            f" {ans}\nIs the answer correct? no",
        ],
        gold=0 if int(row["label"]) else 1,
    )


def _record(row) -> MCItem:  # superglue.py ReCoRD (entity cloze)
    initial, *highlights = row["passage"].strip().split("\n@highlight\n")
    text = initial + "\n\n"
    for h in highlights:
        text += f"  - {h}.\n"
    entities = sorted(set(row["entities"]))  # superglue.py:315-320
    answers = set(row["answers"])
    golds = [i for i, e in enumerate(entities) if e in answers] or [0]
    return MCItem(
        context=text,
        choices=[
            f"  - {row['query']}".replace("@placeholder", e) for e in entities
        ],
        gold=golds[0],
        gold_all=golds,  # any correct entity counts (process_results)
    )


def _cbt(row) -> MCItem:  # cbt.py:73-110 (full-passage scoring per option)
    passage = " ".join(row["sentences"])
    text = _detok("Passage: " + passage + "\nQuestion: " + row["question"])
    return MCItem(
        context="",
        choices=[text.replace("XXXXX", o) for o in row["options"]],
        gold=list(row["options"]).index(row["answer"]),
    )


TASK_ADAPTERS = {
    "piqa": _piqa,
    "arc_easy": _arc,
    "arc_challenge": _arc,
    "boolq": _boolq,
    "hellaswag": _hellaswag,
    "winogrande": _winogrande,
    "openbookqa": _openbookqa,
    "sciq": _sciq,
    "copa": _copa,
    "storycloze": _storycloze,
    "race": _race,
    "swag": _swag,
    "mathqa": _mathqa,
    "truthfulqa_mc1": _truthfulqa_mc1,
    "logiqa": _logiqa,
    "wsc273": _wsc273,
    "hendrycks_test": _mmlu,
    "mmlu": _mmlu,
    "anli": _anli,
    "cb": _cb,
    "rte": _rte,
    "wic": _wic,
    "pubmedqa": _pubmedqa,
    "cola": _glue_cola,
    "sst": _glue_sst,
    "mnli": _glue_mnli,
    "qnli": _glue_qnli,
    "wnli": _glue_wnli,
    "glue_rte": _glue_rte,
    "mrpc": _glue_mrpc,
    "qqp": _glue_qqp,
    "headqa": _headqa,
    "prost": _prost,
    "qa4mre": _qa4mre,
    "sat_analogies": _sat,
    "toxigen": _toxigen,
    "ethics_cm": _ethics_cm,
    "ethics_justice": _ethics_justice,
    "ethics_deontology": _ethics_deontology,
    "ethics_utilitarianism": _ethics_utilitarianism,
    "ethics_virtue": _ethics_virtue,
    "sg_wsc": _sg_wsc,
    "mc_taco": _mc_taco,
    "mutual": _mutual,
    "crows_pairs": _crows_pairs,
    "blimp": _blimp,
    "cbt": _cbt,
    "multirc": _multirc,
    "record": _record,
}


def evaluate_greedy_completion(
    forward_fn: Callable,
    tokenizer,
    pairs: Sequence[Tuple[str, str]],  # (context, exact completion)
    batch_size: int = 8,
    max_len: int = 2048,
) -> Dict[str, float]:
    """acc = every completion token argmax-correct (lm_eval ``is_greedy``
    request semantics — the arithmetic/asdiv scoring rule, reference
    arithmetic.py:51-60) + completion perplexity."""
    ctxs, conts = [], []
    for pre, cont in pairs:
        ctx_ids = tokenizer(pre, return_tensors="np").input_ids[0].tolist()
        full = tokenizer(pre + cont, return_tensors="np").input_ids[0].tolist()
        # continuation tokens = suffix of the full encoding beyond the prefix
        ctxs.append(ctx_ids)
        conts.append(full[len(ctx_ids):])
    n_correct, nll, ntok = 0, 0.0, 0
    doc_nlls: List[float] = []
    for i in range(0, len(ctxs), batch_size):
        cb, kb = ctxs[i : i + batch_size], conts[i : i + batch_size]
        rows, ce, cl = [], [], []
        for c, k in zip(cb, kb):
            seq = (c + k)[-max_len:]
            rows.append(np.asarray(seq, np.int32))
            cl.append(len(k))
            ce.append(len(seq))
        ids, lens = _pad_batch(rows, len_multiple=64)
        logits_t = _logits(forward_fn, ids).to(torch.float32)
        lp = torch.log_softmax(logits_t, dim=-1).cpu().numpy()
        logits = logits_t.cpu().numpy()
        for r in range(len(rows)):
            ok = True
            doc_nll = 0.0
            for t_ in range(ce[r] - cl[r], ce[r]):
                tok = rows[r][t_]
                doc_nll -= lp[r, t_ - 1, tok]
                ntok += 1
                if int(np.argmax(logits[r, t_ - 1])) != tok:
                    ok = False
            nll += doc_nll
            doc_nlls.append(doc_nll)
            n_correct += int(ok)
    return {
        "acc": n_correct / max(len(ctxs), 1),
        # token-level ppl over all continuation tokens
        "ppl": float(math.exp(nll / max(ntok, 1))),
        # lm_eval `perplexity` aggregation: exp(-mean over DOCS of the
        # continuation loglikelihood) — the lambada "ppl" metric
        # (lambada.py:63-69)
        "ppl_doc": float(math.exp(np.mean(doc_nlls))) if doc_nlls else 1.0,
        "n": len(ctxs),
    }


def evaluate_lambada(
    forward_fn: Callable,
    tokenizer,
    texts: Sequence[str],
    batch_size: int = 8,
    max_len: int = 2048,
) -> Dict[str, float]:
    """LAMBADA: predict the final word of each passage. Reports greedy
    accuracy (all final-word tokens argmax-correct) and final-word ppl
    (lm-eval lambada task semantics). ``cloze`` style (lambada_cloze.py:36)
    is the same scoring with ' ____. ->' appended to the context — pass
    texts already rewritten via :func:`lambada_cloze_pairs`."""
    pairs = []
    for t in texts:
        t = t.strip()
        pre, last = t.rsplit(" ", 1)
        pairs.append((pre, " " + last))
    out = evaluate_greedy_completion(
        forward_fn, tokenizer, pairs, batch_size=batch_size, max_len=max_len
    )
    # lm_eval lambada "ppl" is the DOC-level perplexity of the final word
    out["ppl"] = out.pop("ppl_doc")
    return out


def lambada_cloze_pairs(texts: Sequence[str]) -> List[Tuple[str, str]]:
    """Cloze-style LAMBADA (reference lambada_cloze.py:36): context gets the
    ' ____. ->' fill-in marker; completion is still the final word."""
    out = []
    for t in texts:
        t = t.strip()
        pre, last = t.rsplit(" ", 1)
        out.append((pre + " ____. ->", " " + last))
    return out


def load_task_items(name: str, data_dir: str, split: str = "validation") -> List[MCItem]:
    """Load a task from a datasets.save_to_disk directory (offline)."""
    from flexq_tpu_torch.eval.data import _load_from_disk

    ds = _load_from_disk(data_dir)
    if split in getattr(ds, "keys", lambda: [])():
        ds = ds[split]
    adapter = TASK_ADAPTERS[name]
    rows = collate_race(ds) if name == "race" else ds
    return [adapter(row) for row in rows]


# --- generation-based tasks (greedy_until + exact-match/F1 scoring) ---------

@dataclasses.dataclass
class GenItem:
    """One generation instance: prompt + acceptable answers."""

    context: str
    answers: List[str]


def _normalize_answer(s: str) -> str:
    """SQuAD-style normalization: lowercase, strip articles/punct/whitespace."""
    import re
    import string

    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def _f1(pred: str, gold: str) -> float:
    p = _normalize_answer(pred).split()
    g = _normalize_answer(gold).split()
    if not p or not g:
        return float(p == g)
    common = {}
    for t in p:
        common[t] = min(p.count(t), g.count(t))
    overlap = sum(common.values())
    if overlap == 0:
        return 0.0
    prec = overlap / len(p)
    rec = overlap / len(g)
    return 2 * prec * rec / (prec + rec)


def evaluate_generation(
    generate_fn: Callable[[List[int], int], List[int]],  # ids, max_new -> ids
    tokenizer,
    items: Sequence[GenItem],
    max_new_tokens: int = 64,
    stop_strings: Sequence[str] = ("\n",),
    extract_number: bool = False,
) -> Dict[str, float]:
    """Greedy-until evaluation (lm_eval greedy_until request type — the
    harness class behind squad/triviaqa/gsm8k/drop). Scores exact match and
    token F1 against the answer set; ``extract_number`` pulls the last
    number from the completion first (gsm8k final-answer convention)."""
    import re

    em = 0.0
    f1 = 0.0
    for item in items:
        ids = tokenizer(item.context, return_tensors="np").input_ids[0].tolist()
        out_ids = generate_fn(ids, max_new_tokens)
        text = tokenizer.decode(out_ids) if hasattr(tokenizer, "decode") else "".join(
            chr(t) for t in out_ids
        )
        for stop in stop_strings:
            if stop in text:
                text = text[: text.index(stop)]
        if extract_number:
            nums = re.findall(r"-?\d[\d,]*\.?\d*", text.replace(",", ""))
            text = nums[-1] if nums else text
        em += max(
            float(_normalize_answer(text) == _normalize_answer(a))
            for a in item.answers
        )
        f1 += max(_f1(text, a) for a in item.answers)
    n = max(len(items), 1)
    return {"exact_match": em / n, "f1": f1 / n, "n": len(items)}


def _squad(row) -> GenItem:
    return GenItem(
        context=(
            f"Title: {row.get('title', '')}\n\nBackground: {row['context']}\n\n"
            f"Question: {row['question']}\n\nAnswer:"
        ),
        answers=list(row["answers"]["text"]) or [""],
    )


def _triviaqa(row) -> GenItem:
    ans = row["answer"]
    aliases = list(ans.get("aliases", [])) or [ans.get("value", "")]
    return GenItem(
        context=f"Question: {row['question']}\nAnswer:",
        answers=aliases,
    )


def _gsm8k(row) -> GenItem:
    gold = row["answer"].split("####")[-1].strip()
    return GenItem(
        context=f"Question: {row['question']}\nAnswer:",
        answers=[gold],
    )


def _webqs(row) -> GenItem:
    return GenItem(
        context=f"Question: {row['question']}\nAnswer:",
        answers=list(row["answers"]),
    )


def _naturalqs(row) -> GenItem:
    # natural_questions open variant: question + short answers
    q = row["question"]
    if isinstance(q, dict):
        q = q.get("text", "")
    ans = row.get("answer") or row.get("answers") or [""]
    return GenItem(context=f"Q: {q}\n\nA:", answers=list(ans))


def _drop(row) -> GenItem:  # drop.py:114-116; answers = spans/number/date
    ans = row.get("answers_spans") or {}
    answers = list(ans.get("spans", [])) or [""]
    return GenItem(
        context=f"Passage: {row['passage']}\nQuestion: {row['question']}\nAnswer:",
        answers=answers,
    )


def _unscramble(row) -> GenItem:  # unscramble.py:49-60 (EM on completion)
    return GenItem(context=row["context"], answers=[row["completion"].strip()])


def _asdiv_pair(row) -> Tuple[str, str]:
    """asdiv is an is_greedy task (asdiv.py:51-86): feed the pairs to
    evaluate_greedy_completion."""
    ctx = row["body"] + "\n" + "Question:" + row["question"] + "\n" + "Answer:"
    return ctx, " " + str(row["answer"]).split(" ")[0]


def _arithmetic_pair(row) -> Tuple[str, str]:
    """arithmetic_* tasks (arithmetic.py:51-60): exact greedy completion."""
    return row["context"], row["completion"]


def _last_boxed(s: str) -> Optional[str]:
    """Extract the contents of the last \\boxed{...} (hendrycks_math.py
    last_boxed_only_string + remove_boxed semantics)."""
    idx = s.rfind("\\boxed{")
    if idx < 0:
        fidx = s.rfind("\\fbox{")
        if fidx < 0:
            return None
        idx = fidx + len("\\fbox{")
    else:
        idx = idx + len("\\boxed{")
    depth = 1
    for j in range(idx, len(s)):
        if s[j] == "{":
            depth += 1
        elif s[j] == "}":
            depth -= 1
            if depth == 0:
                return s[idx:j]
    return None


def _hendrycks_math(row) -> GenItem:  # hendrycks_math.py:50,76
    gold = _last_boxed(row["solution"]) or row["solution"].strip()
    return GenItem(
        context="Problem: " + row["problem"] + "\nAnswer:",
        answers=[gold],
    )


def _quac(row) -> GenItem:  # quac.py doc_to_text
    title = row["title"] + " - " + row.get("section_title", "")
    ans = row.get("answers") or row.get("answer") or [""]
    if isinstance(ans, dict):
        ans = ans.get("texts") or ans.get("text") or [""]
    return GenItem(
        context=(
            f"TITLE: {title}\nPARAGRAPH: {row['paragraph']}\n\n"
            f"Q: {row['question']}\n\nA: "
        ),
        answers=[a for a in ans if a] or [""],
    )


def _qasper(row) -> GenItem:  # qasper.py doc_to_text (free-form subset)
    ans = row.get("answers") or [row.get("answer", "")]
    if isinstance(ans, dict):
        ans = ans.get("text") or [""]
    return GenItem(
        context=(
            f"TITLE: {row['title']}\nABSTRACT: {row['abstract']}\n\n"
            f"Q: {row['question']}\n\nA:"
        ),
        answers=[str(a) for a in ans if a] or [""],
    )


def translation_item(row, src_lang: str, tar_lang: str) -> GenItem:
    """translation.py doc_to_text: '<Src> phrase: ...\\n<Tar> phrase:'."""
    refs = row["ref"] if isinstance(row["ref"], list) else [row["ref"]]
    return GenItem(
        context=f"{src_lang} phrase: " + row["src"] + f"\n{tar_lang} phrase:",
        answers=[" " + r for r in refs],
    )


def corpus_bleu(
    hypotheses: Sequence[str], references: Sequence[Sequence[str]],
    max_n: int = 4,
) -> float:
    """Corpus-level BLEU-4 (uniform weights, brevity penalty) — the
    translation-task metric (translation.py uses sacrebleu; this is the
    standard Papineni BLEU on whitespace tokens, no external deps)."""
    from collections import Counter

    clipped = [0] * max_n
    totals = [0] * max_n
    hyp_len = 0
    ref_len = 0
    for hyp, refs in zip(hypotheses, references):
        h = hyp.split()
        rs = [r.split() for r in refs]
        hyp_len += len(h)
        ref_len += min((abs(len(r) - len(h)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            h_ngrams = Counter(
                tuple(h[i : i + n]) for i in range(len(h) - n + 1)
            )
            max_ref = Counter()
            for r in rs:
                r_ngrams = Counter(
                    tuple(r[i : i + n]) for i in range(len(r) - n + 1)
                )
                for g, c in r_ngrams.items():
                    max_ref[g] = max(max_ref[g], c)
            clipped[n - 1] += sum(min(c, max_ref[g]) for g, c in h_ngrams.items())
            totals[n - 1] += max(sum(h_ngrams.values()), 0)
    if not hyp_len:
        return 0.0
    # smoothing: orders with no hypothesis n-grams at all (corpus shorter
    # than n) are skipped; zero clipped counts take eps=0.1 (Lin&Och m.1)
    logs = []
    for c, t in zip(clipped, totals):
        if t == 0:
            continue
        logs.append(math.log(max(c, 0.1) / t))
    if not logs:
        return 0.0
    log_p = sum(logs) / len(logs)
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    return float(100.0 * bp * math.exp(log_p))


def evaluate_translation(
    generate_fn: Callable[[List[int], int], List[int]],
    tokenizer,
    items: Sequence[GenItem],
    max_new_tokens: int = 128,
    stop_strings: Sequence[str] = ("\n",),
) -> Dict[str, float]:
    """Greedy translation + corpus BLEU (translation.py task flow)."""
    hyps, refs = [], []
    for item in items:
        ids = tokenizer(item.context, return_tensors="np").input_ids[0].tolist()
        out_ids = generate_fn(ids, max_new_tokens)
        text = tokenizer.decode(out_ids)
        for stop in stop_strings:
            if stop in text:
                text = text[: text.index(stop)]
        hyps.append(text.strip())
        refs.append([a.strip() for a in item.answers])
    return {"bleu": corpus_bleu(hyps, refs), "n": len(items)}


def _coqa(row) -> GenItem:  # coqa.py doc_to_text; final turn of the dialog
    from itertools import zip_longest

    text = row["story"] + "\n\n"
    for q, a in zip_longest(
        row["questions"]["input_text"], row["answers"]["input_text"][:-1]
    ):
        text += f"Q: {q}\n\n" + (f"A: {a}\n\n" if a is not None else "A:")
    return GenItem(context=text, answers=[row["answers"]["input_text"][-1]])


GEN_TASK_ADAPTERS = {
    "squad": _squad,
    "triviaqa": _triviaqa,
    "gsm8k": _gsm8k,
    "webqs": _webqs,
    "naturalqs": _naturalqs,
    "drop": _drop,
    "anagrams1": _unscramble,
    "anagrams2": _unscramble,
    "cycle_letters": _unscramble,
    "random_insertion": _unscramble,
    "reversed_words": _unscramble,
    "coqa": _coqa,
    "hendrycks_math": _hendrycks_math,
    "quac": _quac,
    "qasper_freeform": _qasper,
}

# is_greedy request-type tasks: row -> (context, completion) pairs for
# evaluate_greedy_completion
GREEDY_PAIR_ADAPTERS = {
    "arithmetic": _arithmetic_pair,
    "asdiv": _asdiv_pair,
}


# --- perplexity tasks (rolling loglikelihood: wikitext / pile) ---------------

def rolling_token_windows(
    tokens: Sequence[int], prefix_token: int, max_seq_len: int
) -> List[Tuple[List[int], List[int]]]:
    """Disjoint (context, prediction) windows over one document (reference
    lm_eval utils.py:72-116 ``get_rolling_token_windows`` with context_len=1
    composed with ``make_disjoint_window``): every token is predicted exactly
    once; the first window conditions only on ``prefix_token`` (EOT)."""
    tokens = list(tokens)
    if not tokens:
        return []
    out: List[Tuple[List[int], List[int]]] = []
    first = min(max_seq_len, len(tokens))
    out.append(([prefix_token], tokens[:first]))
    predicted = first
    while predicted < len(tokens):
        pred_len = min(len(tokens) - predicted, max_seq_len)
        end = predicted + pred_len
        # full-size context for the last partial window (base.py:56-75)
        ctx = tokens[max(0, end - max_seq_len - 1) : end - pred_len]
        out.append((ctx if ctx else [prefix_token], tokens[end - pred_len : end]))
        predicted += pred_len
    return out


def loglikelihood_rolling(
    forward_fn: Callable,
    docs_tokens: Sequence[Sequence[int]],
    prefix_token: int,
    max_len: int = 2048,
    batch_size: int = 8,
) -> np.ndarray:
    """Σ log p(token) over each full document, chunked into rolling windows
    (reference base.py:187-210 ``loglikelihood_rolling``)."""
    ctxs: List[List[int]] = []
    conts: List[List[int]] = []
    owner: List[int] = []
    for d, toks in enumerate(docs_tokens):
        for ctx, cont in rolling_token_windows(toks, prefix_token, max_len):
            ctxs.append(ctx)
            conts.append(cont)
            owner.append(d)
    scores = np.zeros(len(ctxs), np.float64)
    for i in range(0, len(ctxs), batch_size):
        scores[i : i + batch_size] = loglikelihood_batch(
            forward_fn, ctxs[i : i + batch_size], conts[i : i + batch_size], max_len,
            pad_rows_to=batch_size,
        )
    out = np.zeros(len(docs_tokens), np.float64)
    for d, s in zip(owner, scores):
        out[d] += s
    return out


def evaluate_perplexity_docs(
    forward_fn: Callable,
    tokenizer,
    docs: Sequence[str],
    max_len: int = 2048,
    batch_size: int = 8,
) -> Dict[str, float]:
    """PerplexityTask metrics (reference base.py:681-760 + metrics.py:98-108):
    word_perplexity = exp(-Σll / Σwords), byte_perplexity = exp(-Σll / Σbytes),
    bits_per_byte = -Σll / (Σbytes·ln 2). Used by the wikitext and pile_*
    tasks (pile.py:28-47)."""
    import re as _re

    eot = getattr(tokenizer, "eos_token_id", None) or 0
    docs_tokens = [
        tokenizer(d, return_tensors="np").input_ids[0].tolist() for d in docs
    ]
    lls = loglikelihood_rolling(
        forward_fn, docs_tokens, prefix_token=eot, max_len=max_len,
        batch_size=batch_size,
    )
    words = sum(len(_re.split(r"\s+", d)) for d in docs)
    bytes_ = sum(len(d.encode("utf-8")) for d in docs)
    total_ll = float(np.sum(lls))
    return {
        "word_perplexity": math.exp(-total_ll / max(words, 1)),
        "byte_perplexity": math.exp(-total_ll / max(bytes_, 1)),
        "bits_per_byte": -total_ll / (max(bytes_, 1) * math.log(2)),
        "n": len(docs),
    }


# The Pile perplexity subsets (pile.py:50-208): each is
# evaluate_perplexity_docs over that subset's "text" column. Data-gated —
# this environment has no pile shards; load via eval.data.load_eval_docs.
PILE_SUBSETS = (
    "pile_arxiv", "pile_books3", "pile_bookcorpus2", "pile_dm-mathematics",
    "pile_enron", "pile_europarl", "pile_freelaw", "pile_github",
    "pile_gutenberg", "pile_hackernews", "pile_nih-exporter",
    "pile_opensubtitles", "pile_openwebtext2", "pile_philpapers",
    "pile_pile-cc", "pile_pubmed-abstracts", "pile_pubmed-central",
    "pile_stackexchange", "pile_ubuntu-irc", "pile_uspto", "pile_wikipedia",
    "pile_youtubesubtitles",
)

# lambada_multilingual.py:33-60: LambadaOpenAI scoring over machine-translated
# splits; evaluate via evaluate_lambada on each language's texts.
LAMBADA_MULTILINGUAL_LANGS = ("en", "fr", "de", "it", "es")


def evaluate_truthfulqa_mc2(
    forward_fn: Callable,
    tokenizer,
    rows: Sequence[dict],
    batch_size: int = 8,
    max_len: int = 2048,
) -> Dict[str, float]:
    """TruthfulQA mc2 (truthfulqa.py:148-159): normalized probability mass on
    the true answers. ``mc2_targets.labels`` is 1 for every true choice, then
    0 for every false one."""
    ctxs: List[List[int]] = []
    conts: List[List[int]] = []
    spans: List[Tuple[int, int, int]] = []  # (start, n, n_true)
    for row in rows:
        tgt = row["mc2_targets"]
        labels = list(tgt["labels"])
        n_true = labels.index(0) if 0 in labels else len(labels)
        context = TRUTHFULQA_QA_PROMPT + "\n\nQ: " + row["question"] + "\nA:"
        start = len(ctxs)
        ctx_ids = tokenizer(context, return_tensors="np").input_ids[0].tolist()
        for choice in tgt["choices"]:
            whole = tokenizer(
                context + " " + choice, return_tensors="np"
            ).input_ids[0].tolist()
            ctxs.append(ctx_ids)
            conts.append(whole[len(ctx_ids):])
        spans.append((start, len(tgt["choices"]), n_true))
    scores = np.zeros(len(ctxs), np.float64)
    for i in range(0, len(ctxs), batch_size):
        scores[i : i + batch_size] = loglikelihood_batch(
            forward_fn, ctxs[i : i + batch_size], conts[i : i + batch_size], max_len,
            pad_rows_to=batch_size,
        )
    vals = []
    for start, n, n_true in spans:
        p = np.exp(scores[start : start + n])
        vals.append(float(p[:n_true].sum() / max(p.sum(), 1e-30)))
    return {"mc2": float(np.mean(vals)), "n": len(rows)}
