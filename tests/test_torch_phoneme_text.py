"""The port's phoneme text stack (tokenizer/phoneme.py, phoneme_frontend.py,
polyphone.py) against the JAX package's: PhonemeTokenizer on a seeded
phoneme dict, get_frontend_result key by key on the tagged texts of
tests/test_phoneme_frontend.py with the same stub g2p, and the polyphone
floor on its golden strings and on 200 seeded random strings.  All pure
Python: the two must agree exactly."""
import json

import numpy as np
import pytest

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from cosyvoice_tpu.tokenizer import phoneme as JP
from cosyvoice_tpu.tokenizer import phoneme_frontend as JF
from cosyvoice_tpu.tokenizer import polyphone as JPoly
from cosyvoice_tpu_torch.tokenizer import phoneme as TP
from cosyvoice_tpu_torch.tokenizer import phoneme_frontend as TF
from cosyvoice_tpu_torch.tokenizer import polyphone as TPoly

# a seeded phoneme dict in the layout of hnttsa_phoneme2id.json (which does
# not ship here): pause labels, punctuation, initials and finals, English
PHONEMES = (["<k>", "<p>", "<g>", "<t>", "<s>", ".", ",", "?"]
            + ["b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h", "j", "q", "x", "zh",
               "ch", "sh", "r", "z", "c", "s", "a", "o", "e", "i", "u", "v", "ai", "ei",
               "ao", "ou", "an", "en", "ang", "eng", "ong", "in", "ian", "uar", "B", "AA",
               "CH", "IY", "AY", "T", "OW", "HH"])
PROSODY = ["#1", "#2", "#3", "#4", "$1", "$2", "$3", "$4"]


@pytest.fixture(scope="module")
def dict_path(tmp_path_factory):
    ids = np.random.default_rng(0).permutation(len(PHONEMES)) + 1
    path = tmp_path_factory.mktemp("pho") / "phoneme2id.json"
    path.write_text(json.dumps({p: int(i) for p, i in zip(PHONEMES, ids)}))
    return str(path)


def _random_stream(rng, n):
    """n phoneme strings: dict phonemes with 0-2 tone digits (14 English),
    prosody marks and pause labels among them."""
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.15:
            out.append(PROSODY[rng.integers(len(PROSODY))])
            continue
        pho = PHONEMES[rng.integers(len(PHONEMES))]
        if not pho.startswith("<") and pho not in ".,?":
            tone = rng.choice(["", "1", "2", "3", "4", "5", "14"])
            pho = pho + tone
        out.append(pho)
    return out


@pytest.mark.parametrize("use_pause_label", [True, False])
def test_phoneme_tokenizer_matches_jax(dict_path, use_pause_label):
    """encode on the phoneme list of tests/test_llm_phoneme.py and on 50
    seeded streams; encode_with_prosody and encode_text (a stub g2p) on
    seeded pre-g2p'd streams."""
    j = JP.PhonemeTokenizer(dict_path, use_pause_label=use_pause_label)
    t = TP.PhonemeTokenizer(dict_path, use_pause_label=use_pause_label)
    rng = np.random.default_rng(1)
    streams = [["B", "AA4", "#1", "CH", "IY14", "<p>", "#3", "AY1", "T", "#4", "."]]
    streams += [_random_stream(rng, int(rng.integers(1, 40))) for _ in range(50)]
    for s in streams:
        assert t.encode(s) == j.encode(s), s
    for _ in range(50):
        n = int(rng.integers(1, 30))
        phos = [PROSODY[rng.integers(8)] if rng.random() < 0.2
                else PHONEMES[rng.integers(len(PHONEMES))] for _ in range(n)]
        tones = rng.integers(0, 16, n).tolist()
        langs = rng.integers(0, 2, n).tolist()
        assert t.encode_with_prosody(phos, tones, langs) == \
            j.encode_with_prosody(phos, tones, langs), phos
        g2p = lambda text: {"pho": phos, "tone": tones, "lang": langs}
        assert t.encode_text("任意", g2p) == j.encode_text("任意", g2p)


class StubG2P:
    """The stub of tests/test_phoneme_frontend.py: a fixed frontend dict for
    the normalized (tag-free) input."""

    def __init__(self, result):
        self.result = result

    def __call__(self, text):
        return dict(self.result)


def _result_zh():
    """tests/test_phoneme_frontend.py::_result_zh: 今天 | 花儿 (erhua) | 好 |
    oh (English), inline prosody marks with out-of-range alignment ids."""
    return {
        "words": ["今天", "花儿", "好", "oh"],
        "symbols": ["jin1 tian1", "hua1 @er@", "hao3", "@eng@oh"],
        "prosody": ["#0", "#1", "#0", "#2", "#3", "#0"],
        "phonemes": ["j", "in1", "t", "ian1", "#1", "h", "uar1", "#2",
                     "h", "ao3", "#3", "OW"],
        "pho2token_ids": [0, 0, 1, 1, -1, 2, 2, -1, 3, 3, -1, 4],
        "tones": [1, 1, 1, 1, 0, 1, 1, 0, 3, 3, 0, 14],
        "language_ids": [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1],
    }


FRONTEND_KEYS = ["ori_text", "text_token", "pinyins", "phoneme_list", "token_prsd",
                 "token2phonum", "token2phonum_w_prsd", "pho", "tone", "lang"]


@pytest.mark.parametrize("text", ["今天<p>花儿好oh", "今天花儿好oh", "今<k>天花儿好oh",
                                  "今天花儿<s>好oh"])
@pytest.mark.parametrize("interjections", [None, {"oh": "ou1"}], ids=["none", "oh"])
def test_frontend_result_matches_jax(text, interjections):
    assert TF.load_interjections(None) == JF.load_interjections(None) == {}
    got = TF.get_frontend_result(text, StubG2P(_result_zh()), interjection2pho=interjections)
    want = JF.get_frontend_result(text, StubG2P(_result_zh()), interjection2pho=interjections)
    for key in FRONTEND_KEYS:
        assert got[key] == want[key], (key, got[key], want[key])
    assert TF.remove_kpsgt_tag(text) == JF.remove_kpsgt_tag(text)
    laugh = {"words": ["haa", "。"], "symbols": ["@eng@haa", "@punc@."],
             "prosody": ["#0", "#0"], "phonemes": ["HH", "AA", "."],
             "pho2token_ids": [0, 0, 1], "tones": [14, 14, 0], "language_ids": [1, 1, 0]}
    got = TF.get_frontend_result("haa。", StubG2P(laugh))
    want = JF.get_frontend_result("haa。", StubG2P(laugh))
    assert all(got[k] == want[k] for k in FRONTEND_KEYS)


GOLDENS = ("我的书", "的确如此", "目的地", "打的回家", "跑得快", "得到奖励", "我总得去", "地球很大",
           "慢慢地走", "他走了", "了解情况", "受不了啦", "看着我", "别着急", "沉着应对", "自行车",
           "中国银行", "很重要", "重新开始", "很长的路", "他是校长", "还没来", "还钱给我", "快乐时光",
           "听音乐会", "大家都来", "首都机场", "为什么呢", "成为冠军", "理发店", "发现问题", "会计师",
           "我不会", "一只猫", "只有一个", "去睡觉吧", "感觉不错", "很便宜", "方便的话", "时间不多",
           "间接影响", "真是不得了", "照相机", "相信我", "将军来了", "答应他", "上当受骗", "业余爱好",
           "种植水稻", "空调坏了", "到处都是", "水浒传说", "干活去了", "大部分人", "遭遇灾难",
           "数数手指", "弹钢琴曲", "放假三天", "有空再来", "出差很久", "反倒不好", "盛饭给他",
           "缴械投降", "去西藏玩", "率领部队", "勉强同意", "弯曲小路", "奇数偶数", "青少年宫",
           "朝气蓬勃", "一会儿见", "去哪儿呀", "小孩儿哭", "有点儿累", "聊天儿去", "儿子很乖",
           "女儿长大", "婴儿睡了")


def _random_strings(n: int):
    """Strings over the lexicon's characters, its context words' characters,
    儿 and a few others, 1-12 characters long, some with a non-zh entry."""
    lex = TPoly.ZH_POLYPHONES
    chars = sorted(set(lex) | {c for _, words in lex.values() for w in words for c in w}
                   | set("儿你我他的了好人天"))
    rng = np.random.default_rng(2)
    out = []
    for _ in range(n):
        s = [chars[i] for i in rng.integers(0, len(chars), int(rng.integers(1, 13)))]
        if rng.random() < 0.2:
            s[int(rng.integers(len(s)))] = "ab"
        out.append(s)
    return out


def test_polyphones_match_jax():
    """fix_polyphones, apply_erhua and match_polyphone_word on the goldens of
    tests/test_phoneme_frontend.py and on 200 seeded random strings;
    make_polyphone_g2p (lexicon defaults on and off) over a g2p that splits
    each string into 1-3 character words."""
    assert TPoly.ZH_POLYPHONES == JPoly.ZH_POLYPHONES
    assert TPoly.ERHUA_WORDS == JPoly.ERHUA_WORDS
    rng = np.random.default_rng(3)
    cases = [list(s) for s in GOLDENS] + _random_strings(200)
    for chars in cases:
        pin = ["er2" if c == "儿" else "x5" for c in chars]
        assert TPoly.fix_polyphones(chars, pin) == JPoly.fix_polyphones(chars, pin), chars
        assert TPoly.apply_erhua(chars, pin) == JPoly.apply_erhua(chars, pin), chars
        text = "".join(c if len(c) == 1 else "\x00" for c in chars)
        for i, c in enumerate(chars):
            if c in TPoly.ZH_POLYPHONES:
                words = TPoly.ZH_POLYPHONES[c][1]
                assert TPoly.match_polyphone_word(text, i, words) == \
                    JPoly.match_polyphone_word(text, i, words)
        zh = [c for c in chars if len(c) == 1]
        cuts = np.cumsum(rng.integers(1, 4, len(zh)))
        words = ["".join(zh[a:b]) for a, b in zip([0, *cuts], cuts) if a < len(zh)]

        def base(texts, words=words):
            return {"words": list(words), "symbols": ["x5"] * len(words)}

        for char_default in (False, True):
            assert TPoly.make_polyphone_g2p(base, char_default=char_default)("") == \
                JPoly.make_polyphone_g2p(base, char_default=char_default)(""), words
