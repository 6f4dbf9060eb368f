"""High-frequency zh polyphone disambiguation floor.

The port's own copy of cosyvoice_tpu/tokenizer/polyphone.py (pure Python, so
the two agree line for line; the port imports nothing of the JAX package).

The reference resolves polyphones inside its proprietary ttsfrd frontend /
WeTextProcessing (cosyvoice/cli/frontend.py:113-121); neither ships here, so
deployments that plug a naive dictionary g2p into
PhonemeTokenizer.encode_text mispronounce the most common polyphonic
characters.  This module is the documented floor for that gap
(runtime/textnorm.py gap note): a word-context lexicon for the highest-
frequency polyphones, applied as a post-pass over ANY g2p's per-character
pinyin output.

Pinyin format: lowercase syllable + tone digit 1-5 (5 = neutral), the same
convention the reference's phoneme assets use.  Rules are word-lexicon
first (longest context match wins), then the per-character default — the
standard polyphone-floor recipe when no learned disambiguator is available.
This is NOT a replacement for a full g2p model; it bounds the error on the
characters that dominate real zh text (的/地/得/了/着/行/重/长/还/乐/都/
为/发/中/会/只/觉/教/便/间).
"""
from __future__ import annotations

from typing import Optional, Sequence

# char -> (default pinyin, {context word: pinyin-for-this-char}).
# Context keys are 2- or 3-char words containing the character; values give
# the char's reading inside that word.  Longest match anywhere in a +-2 char
# window wins; ties prefer the match whose word starts earliest.
ZH_POLYPHONES: dict = {
    "的": ("de5", {"的确": "di2", "目的": "di4", "标的": "di4",
                   "众矢之的": "di4", "打的": "di1", "的士": "di1"}),
    "地": ("di4", {"慢慢地": "de5", "悄悄地": "de5", "渐渐地": "de5",
                   "好好地": "de5", "默默地": "de5", "轻轻地": "de5",
                   "简单地": "de5", "飞快地": "de5", "不停地": "de5",
                   "狠狠地": "de5"}),
    "得": ("de5", {"得到": "de2", "获得": "de2", "取得": "de2",
                   "值得": "de2", "得意": "de2", "觉得": "de5",
                   "记得": "de5", "懂得": "de5", "得分": "de2",
                   "心得": "de2", "不得不": "de2", "得出": "de2",
                   "得奖": "de2", "得罪": "de2", "得先": "dei3",
                   "得去": "dei3", "总得": "dei3", "非得": "dei3"}),
    "了": ("le5", {"了解": "liao3", "了不起": "liao3", "了结": "liao3",
                   "一目了然": "liao3", "不得了": "liao3", "受不了": "liao3",
                   "了如指掌": "liao3", "没完没了": "liao3"}),
    "着": ("zhe5", {"着急": "zhao2", "着火": "zhao2", "睡着": "zhao2",
                    "着凉": "zhao2", "着迷": "zhao2", "着手": "zhuo2",
                    "着装": "zhuo2", "沉着": "zhuo2", "执着": "zhuo2",
                    "着陆": "zhuo2", "高着": "zhao1"}),
    "行": ("xing2", {"银行": "hang2", "行业": "hang2", "行列": "hang2",
                     "一行": "hang2", "行情": "hang2", "外行": "hang2",
                     "内行": "hang2", "同行业": "hang2", "各行各业": "hang2",
                     "分行": "hang2", "支行": "hang2"}),
    "重": ("zhong4", {"重新": "chong2", "重复": "chong2", "重来": "chong2",
                      "重庆": "chong2", "重叠": "chong2", "重申": "chong2",
                      "重建": "chong2", "重启": "chong2", "重组": "chong2",
                      "双重": "chong2", "重温": "chong2"}),
    "长": ("chang2", {"成长": "zhang3", "长大": "zhang3", "校长": "zhang3",
                      "组长": "zhang3", "市长": "zhang3", "生长": "zhang3",
                      "长辈": "zhang3", "队长": "zhang3", "部长": "zhang3",
                      "增长": "zhang3", "董事长": "zhang3", "家长": "zhang3",
                      "长官": "zhang3", "首长": "zhang3"}),
    "还": ("hai2", {"还钱": "huan2", "归还": "huan2", "还给": "huan2",
                    "偿还": "huan2", "还款": "huan2", "还清": "huan2",
                    "退还": "huan2", "还本": "huan2"}),
    "乐": ("le4", {"音乐": "yue4", "乐器": "yue4", "乐队": "yue4",
                   "乐曲": "yue4", "声乐": "yue4", "乐谱": "yue4",
                   "交响乐": "yue4"}),
    "都": ("dou1", {"首都": "du1", "都市": "du1", "成都": "du1",
                    "都城": "du1", "古都": "du1"}),
    "为": ("wei2", {"因为": "wei4", "为了": "wei4", "为什么": "wei4",
                    "为何": "wei4", "为此": "wei4"}),
    "发": ("fa1", {"头发": "fa4", "理发": "fa4", "发型": "fa4",
                   "毛发": "fa4", "白发": "fa4", "假发": "fa4"}),
    "中": ("zhong1", {"中奖": "zhong4", "中毒": "zhong4", "击中": "zhong4",
                      "命中": "zhong4", "中暑": "zhong4", "猜中": "zhong4"}),
    "会": ("hui4", {"会计": "kuai4", "财会": "kuai4"}),
    "只": ("zhi3", {"一只": "zhi1", "两只": "zhi1", "几只": "zhi1",
                    "三只": "zhi1", "只身": "zhi1"}),
    "觉": ("jue2", {"睡觉": "jiao4", "午觉": "jiao4", "一觉": "jiao4"}),
    "教": ("jiao4", {"教书": "jiao1", "教给": "jiao1", "教会他": "jiao1"}),
    "便": ("bian4", {"便宜": "pian2"}),
    "间": ("jian1", {"间接": "jian4", "间隔": "jian4", "离间": "jian4",
                     "间断": "jian4", "黑白相间": "jian4"}),
    # ---- r5 tier-2 expansion (VERDICT r4 #8: double the coverage) ----
    "相": ("xiang1", {"相机": "xiang4", "照相": "xiang4", "相片": "xiang4",
                      "首相": "xiang4", "相貌": "xiang4", "真相": "xiang4",
                      "扮相": "xiang4"}),
    "将": ("jiang1", {"将军": "jiang4", "大将": "jiang4", "将领": "jiang4",
                      "将士": "jiang4", "麻将": "jiang4"}),
    "应": ("ying1", {"应该": "ying1", "应当": "ying1",
                     "答应": "ying4", "应付": "ying4", "反应": "ying4",
                     "应用": "ying4", "适应": "ying4", "回应": "ying4",
                     "应对": "ying4", "供应": "ying4", "响应": "ying4"}),
    "当": ("dang1", {"当天": "dang4", "上当": "dang4",
                     "当作": "dang4", "当成": "dang4", "恰当": "dang4",
                     "妥当": "dang4", "典当": "dang4", "当铺": "dang4"}),
    "好": ("hao3", {"爱好": "hao4", "好奇": "hao4", "好客": "hao4",
                    "好学": "hao4", "好胜": "hao4", "嗜好": "hao4"}),
    "种": ("zhong3", {"种植": "zhong4", "种地": "zhong4", "种树": "zhong4",
                      "种田": "zhong4", "耕种": "zhong4", "栽种": "zhong4"}),
    "调": ("diao4", {"调整": "tiao2", "调节": "tiao2", "调皮": "tiao2",
                     "调料": "tiao2", "空调": "tiao2", "调解": "tiao2",
                     "协调": "tiao2", "调味": "tiao2", "调侃": "tiao2",
                     "失调": "tiao2"}),
    "处": ("chu4", {"处理": "chu3", "处罚": "chu3", "相处": "chu3",
                    "处置": "chu3", "处于": "chu3", "处境": "chu3",
                    "处分": "chu3", "处在": "chu3", "独处": "chu3"}),
    "传": ("chuan2", {"传记": "zhuan4", "自传": "zhuan4", "传略": "zhuan4",
                      "水浒传": "zhuan4", "外传": "zhuan4"}),
    "干": ("gan4", {"干燥": "gan1", "干净": "gan1", "饼干": "gan1",
                    "干杯": "gan1", "干扰": "gan1", "干涉": "gan1",
                    "干旱": "gan1", "若干": "gan1", "豆腐干": "gan1"}),
    "分": ("fen1", {"分量": "fen4", "部分": "fen4", "身分": "fen4",
                    "成分": "fen4", "水分": "fen4", "过分": "fen4",
                    "本分": "fen4", "缘分": "fen4", "充分": "fen4"}),
    "难": ("nan2", {"灾难": "nan4", "难民": "nan4", "遇难": "nan4",
                    "苦难": "nan4", "患难": "nan4", "责难": "nan4"}),
    "数": ("shu4", {"数数": "shu3", "数不清": "shu3", "数一数": "shu3",
                    "数落": "shu3", "数得上": "shu3"}),
    "弹": ("dan4", {"弹琴": "tan2", "弹吉他": "tan2", "弹奏": "tan2",
                    "弹钢琴": "tan2", "反弹": "tan2", "弹性": "tan2",
                    "弹簧": "tan2"}),
    "血": ("xue4", {"血淋淋": "xie3"}),
    "背": ("bei4", {"背包": "bei1", "背着书包": "bei1", "背负": "bei1",
                    "背债": "bei1", "背黑锅": "bei1"}),
    "假": ("jia3", {"放假": "jia4", "假期": "jia4", "请假": "jia4",
                    "暑假": "jia4", "寒假": "jia4", "休假": "jia4",
                    "度假": "jia4", "病假": "jia4"}),
    "空": ("kong1", {"空闲": "kong4", "空地": "kong4", "填空": "kong4",
                     "抽空": "kong4", "空白": "kong4", "空缺": "kong4",
                     "有空": "kong4", "没空": "kong4"}),
    "差": ("cha4", {"差别": "cha1", "差距": "cha1", "差异": "cha1",
                    "偏差": "cha1", "误差": "cha1", "时差": "cha1",
                    "出差": "chai1", "差遣": "chai1", "邮差": "chai1",
                    "参差": "ci1"}),
    "倒": ("dao3", {"倒车后": "dao4", "倒退": "dao4", "倒立": "dao4",
                    "倒影": "dao4", "倒是": "dao4", "倒计时": "dao4",
                    "倒水": "dao4", "倒茶": "dao4", "反倒": "dao4"}),
    "盛": ("sheng4", {"盛饭": "cheng2", "盛汤": "cheng2", "盛满": "cheng2"}),
    "降": ("jiang4", {"投降": "xiang2", "降服": "xiang2", "降龙": "xiang2"}),
    "藏": ("cang2", {"西藏": "zang4", "藏族": "zang4", "宝藏": "zang4",
                     "藏红花": "zang4"}),
    "率": ("lv4", {"率领": "shuai4", "率先": "shuai4", "坦率": "shuai4",
                   "率真": "shuai4", "轻率": "shuai4", "直率": "shuai4"}),
    "供": ("gong1", {"供品": "gong4", "供奉": "gong4", "口供": "gong4",
                     "招供": "gong4", "上供": "gong4"}),
    "强": ("qiang2", {"勉强": "qiang3", "强迫": "qiang3", "强词夺理": "qiang3",
                      "倔强": "jiang4"}),
    "曲": ("qu3", {"弯曲": "qu1", "曲折": "qu1", "曲线": "qu1",
                   "扭曲": "qu1", "曲解": "qu1"}),
    "奇": ("qi2", {"奇数": "ji1", "奇偶": "ji1"}),
    "少": ("shao3", {"少年": "shao4", "少女": "shao4", "少爷": "shao4",
                     "青少年": "shao4", "少先队": "shao4"}),
    "朝": ("chao2", {"朝气": "zhao1", "朝霞": "zhao1",
                     "朝夕": "zhao1", "朝三暮四": "zhao1"}),
}

# word-final 儿 acting as the retroflex (erhua) suffix in these words is
# NEUTRALIZED: the reference's ttsfrd frontend merges it into the previous
# syllable (hua1 + r); per-character pipelines mark it "r5" (tone-5
# suffix) so the phoneme mapper can fold it.  Standalone 儿 (儿子/女儿/
# 婴儿/幼儿...) keeps its full er2 syllable.
ERHUA_WORDS = ("花儿", "鸟儿", "玩儿", "哪儿", "这儿", "那儿", "一会儿",
               "小孩儿", "孩儿们", "事儿", "味儿", "劲儿", "门儿", "歌儿",
               "活儿", "份儿", "个儿", "面儿", "点儿", "边儿", "头儿",
               "弯儿", "圈儿", "空儿", "词儿", "趣儿", "样儿", "片儿",
               "馅儿", "好玩儿", "差点儿", "有点儿", "没事儿", "聊天儿",
               "一块儿", "一点儿", "一下儿", "等会儿", "待会儿", "遛弯儿")


def apply_erhua(chars: Sequence[str], pinyins: Sequence[str],
                words: Sequence[str] = ERHUA_WORDS) -> list:
    """Rewrite suffix-儿 readings to the neutral retroflex marker 'r5'
    when a known erhua word ends at that position (reference: ttsfrd's
    erhua merge, cosyvoice/cli/frontend.py:113-121 — unavailable here, so
    this floor covers the frequent erhua vocabulary)."""
    text = "".join(c if len(c) == 1 else "\x00" for c in chars)
    out = list(pinyins)
    for i, c in enumerate(chars):
        if c != "儿" or i == 0:
            continue
        for w in words:
            s = i - len(w) + 1
            if s >= 0 and text[s: i + 1] == w:
                out[i] = "r5"
                break
    return out


def match_polyphone_word(text: str, i: int, words: dict) -> Optional[str]:
    """Longest lexicon word covering text position i -> that char's reading,
    or None when no context word matches.  Ties between equal-length words
    prefer the match whose word starts EARLIEST (compare (len, -start) —
    ADVICE r4: the old strict len comparison silently kept dict insertion
    order on equal lengths)."""
    best = None                       # (len, -start, pron)
    for w, pron in words.items():
        # ascending start scan: the first hit for a word is its earliest
        # start (largest -s), so per-word break keeps the best candidate
        for s in range(max(0, i - len(w) + 1), i + 1):
            if text[s: s + len(w)] == w:
                key = (len(w), -s)
                if best is None or key > best[:2]:
                    best = (len(w), -s, pron)
                break
    return best[2] if best is not None else None


def fix_polyphones(chars: Sequence[str], pinyins: Sequence[str],
                   lexicon: Optional[dict] = None) -> list:
    """Override per-character pinyins for known polyphones by word context.

    chars: per-character text (as produced by remove_word_boundary);
    pinyins: the g2p's per-character pinyin (non-zh entries pass through
    untouched).  Returns a new pinyin list.  For each polyphonic char, every
    lexicon word containing it is matched against the surrounding window;
    the LONGEST match wins (earliest start on ties), else the character
    default applies — this function is the floor for a NAIVE per-character
    g2p, so the lexicon default always replaces the input reading.
    """
    lex = ZH_POLYPHONES if lexicon is None else lexicon
    text = "".join(c if len(c) == 1 else "\x00" for c in chars)
    out = list(pinyins)
    for i, c in enumerate(chars):
        if c not in lex:
            continue
        default, words = lex[c]
        pron = match_polyphone_word(text, i, words)
        out[i] = pron if pron is not None else default
    return out


def make_polyphone_g2p(base_g2p, lexicon: Optional[dict] = None,
                       char_default: bool = False):
    """Wrap an external g2p frontend (the PhonemeTokenizer.encode_text /
    phoneme_frontend pipeline input) so its per-word pinyin 'symbols' get
    the polyphone floor applied.  Works on the reference result layout
    ({'words','symbols',...}) for single-char zh word entries — multi-char
    words keep the base g2p's reading (it had word context there).

    A single-char symbol is replaced only when a lexicon CONTEXT WORD
    actually matches around it; with no match the base g2p's reading stands
    (ADVICE r4: unconditionally applying the lexicon default downgraded
    base g2ps that already disambiguate by context/tone).  Pass
    char_default=True to also apply the per-character default on no-match —
    the right setting over a naive dictionary g2p."""

    def g2p(texts):
        result = base_g2p(texts)
        flat = "".join(w.strip() for w in result["words"])
        lex = lexicon or ZH_POLYPHONES
        pos = 0
        for wi, word in enumerate(result["words"]):
            word = word.strip()
            if len(word) == 1 and word in lex:
                default, words = lex[word]
                pron = match_polyphone_word(flat, pos, words)
                if pron is not None:
                    result["symbols"][wi] = pron
                elif char_default:
                    result["symbols"][wi] = default
            pos += len(word)
        return result

    return g2p
